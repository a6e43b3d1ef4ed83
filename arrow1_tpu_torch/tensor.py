"""Dense tensors and the sparse formats COO, CSR and CSF (counterpart of
arrow1_tpu/tensor.py).

Reference: cpp/src/arrow/tensor*.{h,cc} and arrow/tensor/: the dense
Tensor, SparseCOOTensor, SparseCSRMatrix, SparseCSFTensor and their
conversions. A dense Tensor is a torch tensor and its dimension names;
the sparse formats keep the reference's index layouts as tensors on the
same device, so that they convert to and from pyarrow's sparse tensors
at the host boundary. The conversions run on the tensor's device (COO
from ``torch.nonzero``, CSR by one stable sort and a ``searchsorted``,
the CSR product through ``index_add_``); building a CSF tree is host work,
as in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .device import resolve_device
from .errors import Invalid

__all__ = ["Tensor", "SparseCOOTensor", "SparseCSRMatrix",
           "SparseCSFTensor"]


def _names(dim_names):
    return tuple(dim_names) if dim_names else None


def _on(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.require(arr, requirements=("C", "W"))).to(
        device)


def _scatter_dense(coords: torch.Tensor, values: torch.Tensor, shape):
    out = torch.zeros(shape, dtype=values.dtype, device=values.device)
    out[tuple(coords[:, i] for i in range(len(shape)))] = values
    return out


class Tensor:
    """A dense n-dimensional tensor (reference: arrow/tensor.h Tensor)."""

    __slots__ = ("data", "dim_names")

    def __init__(self, data: torch.Tensor,
                 dim_names: Optional[Sequence[str]] = None):
        if not isinstance(data, torch.Tensor):
            raise TypeError("Tensor takes a torch.Tensor; use "
                            "Tensor.from_numpy for a numpy array")
        self.data = data
        self.dim_names = _names(dim_names)

    @classmethod
    def from_numpy(cls, arr, dim_names=None, device=None) -> "Tensor":
        """A numpy array on ``device`` (CUDA unless the caller names the
        CPU)."""
        return cls(_on(np.asarray(arr), resolve_device(device)), dim_names)

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def size(self):
        return int(self.data.numel())

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to_numpy(self) -> np.ndarray:
        return self.data.cpu().numpy()

    def to_arrow(self):
        import pyarrow as pa

        return pa.Tensor.from_numpy(self.to_numpy(),
                                    dim_names=self.dim_names)

    @classmethod
    def from_arrow(cls, t, device=None) -> "Tensor":
        return cls.from_numpy(t.to_numpy(), list(t.dim_names)
                              if t.dim_names else None, device)

    def to_coo(self) -> "SparseCOOTensor":
        """The nonzero entries in row-major order, their coordinates as
        int64[nnz, ndim]."""
        nz = self.data != 0
        return SparseCOOTensor(torch.nonzero(nz), self.data[nz], self.shape,
                               self.dim_names)

    def __repr__(self):
        return f"Tensor{self.shape} {self.data.dtype}"


class SparseCOOTensor:
    """COO: int64[nnz, ndim] coordinates and their values (reference:
    arrow/sparse_tensor.h SparseCOOIndex)."""

    __slots__ = ("coords", "values", "shape", "dim_names")

    def __init__(self, coords, values, shape, dim_names=None):
        self.coords = coords
        self.values = values
        self.shape = tuple(shape)
        self.dim_names = _names(dim_names)

    @property
    def non_zero_length(self) -> int:
        return int(self.values.shape[0])

    def to_dense(self) -> Tensor:
        return Tensor(_scatter_dense(self.coords, self.values, self.shape),
                      self.dim_names)

    def to_csf(self) -> "SparseCSFTensor":
        return SparseCSFTensor.from_coo(self)

    def to_csr(self) -> "SparseCSRMatrix":
        """Entries sorted by (row, column), one stable sort; each row's
        start by a ``searchsorted``."""
        if len(self.shape) != 2:
            raise Invalid("CSR requires a 2-D tensor")
        rows, cols = self.coords[:, 0], self.coords[:, 1]
        order = torch.sort(rows * self.shape[1] + cols, stable=True).indices
        rows = rows[order]
        indptr = torch.searchsorted(rows, torch.arange(
            self.shape[0] + 1, dtype=rows.dtype, device=rows.device))
        return SparseCSRMatrix(indptr, cols[order], self.values[order],
                               self.shape, self.dim_names)

    def to_arrow(self):
        """pyarrow's SparseCOOTensor; one of no entries through its dense
        zeros (pyarrow's from_numpy refuses empty coordinates)."""
        import pyarrow as pa

        values = self.values.cpu().numpy()
        if not len(values):
            return pa.SparseCOOTensor.from_tensor(pa.Tensor.from_numpy(
                np.zeros(self.shape, values.dtype),
                dim_names=self.dim_names))
        return pa.SparseCOOTensor.from_numpy(
            values, self.coords.cpu().numpy(), self.shape,
            dim_names=self.dim_names)

    @classmethod
    def from_arrow(cls, t, device=None) -> "SparseCOOTensor":
        dev = resolve_device(device)
        values, coords = t.to_numpy()
        return cls(_on(coords.astype(np.int64), dev), _on(values.ravel(),
                                                          dev),
                   t.shape, list(t.dim_names) if t.dim_names else None)


class SparseCSRMatrix:
    """CSR: int64 indptr[rows + 1], column indices and values (reference:
    arrow/sparse_tensor.h SparseCSRIndex)."""

    __slots__ = ("indptr", "indices", "values", "shape", "dim_names")

    def __init__(self, indptr, indices, values, shape, dim_names=None):
        self.indptr = indptr
        self.indices = indices
        self.values = values
        self.shape = tuple(shape)
        self.dim_names = _names(dim_names)

    @property
    def non_zero_length(self) -> int:
        return int(self.values.shape[0])

    def _rows(self) -> torch.Tensor:
        """Each entry's row (int64[nnz])."""
        lengths = self.indptr[1:] - self.indptr[:-1]
        return torch.repeat_interleave(
            torch.arange(self.shape[0], device=self.indptr.device), lengths,
            output_size=self.non_zero_length)

    def to_dense(self) -> Tensor:
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.values.device)
        out[self._rows(), self.indices] = self.values
        return Tensor(out, self.dim_names)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x: each entry's product added into its row with
        ``index_add_`` (the sums' order is the device's)."""
        prod = self.values * x[self.indices]
        return torch.zeros(self.shape[0], dtype=prod.dtype,
                           device=prod.device).index_add_(0, self._rows(),
                                                          prod)

    def to_arrow(self):
        import pyarrow as pa

        return pa.SparseCSRMatrix.from_numpy(
            self.values.cpu().numpy(), self.indptr.cpu().numpy(),
            self.indices.cpu().numpy(), self.shape,
            dim_names=self.dim_names)


class SparseCSFTensor:
    """CSF, compressed sparse fibres (reference: arrow/sparse_tensor.h
    SparseCSFIndex): a prefix tree over the sorted coordinates, where
    ``indptr[k]`` maps the level-k nodes to their children's range and
    ``indices[k]`` holds each node's coordinate along ``axis_order[k]``;
    ``indices`` has one tensor a dimension (the last nnz long), ``indptr``
    ndim - 1. The values are sorted lexicographically by coordinate, as
    pyarrow lays them out."""

    __slots__ = ("indptr", "indices", "values", "shape", "axis_order",
                 "dim_names")

    def __init__(self, indptr, indices, values, shape, axis_order=None,
                 dim_names=None):
        self.indptr = tuple(indptr)
        self.indices = tuple(indices)
        self.values = values
        self.shape = tuple(shape)
        self.axis_order = tuple(axis_order) if axis_order is not None \
            else tuple(range(len(self.shape)))
        self.dim_names = _names(dim_names)

    @property
    def non_zero_length(self) -> int:
        return int(self.values.shape[0])

    @classmethod
    def from_coo(cls, coo: SparseCOOTensor) -> "SparseCSFTensor":
        """The prefix tree of the COO coordinates, built on the host (a
        lexsort) and put on the COO's device."""
        dev = coo.values.device
        coords = coo.coords.cpu().numpy()
        vals = coo.values.cpu().numpy()
        nnz, n = coords.shape
        # the smaller axes toward the root share the most prefixes (the
        # reference converter's order, tensor/csf_converter.cc)
        axis_order = np.argsort(np.asarray(coo.shape), kind="stable")
        coords = coords[:, axis_order]
        order = np.lexsort(coords.T[::-1])
        coords, vals = coords[order], vals[order]
        indptr, indices = [], []
        prev_starts = None
        for k in range(n):
            if nnz:
                is_new = np.ones(nnz, dtype=bool)
                is_new[1:] = (coords[1:, :k + 1] != coords[:-1, :k + 1]
                              ).any(axis=1)
                starts = np.flatnonzero(is_new)
            else:
                starts = np.zeros(0, np.int64)
            indices.append(_on(coords[starts, k].astype(np.int64), dev))
            if k > 0:
                bounds = np.concatenate([prev_starts, [nnz]])
                indptr.append(_on(np.searchsorted(starts, bounds)
                                  .astype(np.int64), dev))
            prev_starts = starts
        return cls(indptr, indices, _on(vals, dev), coo.shape,
                   axis_order.tolist(), coo.dim_names)

    def _coords(self) -> np.ndarray:
        """The tree walked back to int64[nnz, ndim] coordinates (host)."""
        n = len(self.shape)
        rows = self.indices[0].cpu().numpy().reshape(-1, 1)
        for k in range(1, n):
            ptr = self.indptr[k - 1].cpu().numpy()
            parent = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
            rows = np.column_stack([rows[parent],
                                    self.indices[k].cpu().numpy()])
        out = np.empty_like(rows)
        out[:, list(self.axis_order)] = rows
        return out

    def to_coo(self) -> SparseCOOTensor:
        return SparseCOOTensor(_on(self._coords(), self.values.device),
                               self.values, self.shape, self.dim_names)

    def to_dense(self) -> Tensor:
        return self.to_coo().to_dense()

    def to_arrow(self):
        import pyarrow as pa

        return pa.SparseCSFTensor.from_numpy(
            self.values.cpu().numpy(),
            [p.cpu().numpy() for p in self.indptr],
            [i.cpu().numpy() for i in self.indices],
            self.shape, axis_order=list(self.axis_order),
            dim_names=self.dim_names)

    @classmethod
    def from_arrow(cls, t, device=None) -> "SparseCSFTensor":
        """pyarrow keeps the axis order to itself, so the tree is built
        again from the dense view (the ascending-size order)."""
        return Tensor.from_numpy(t.to_tensor().to_numpy(),
                                 list(t.dim_names) if t.dim_names else None,
                                 device).to_coo().to_csf()

    def __repr__(self):
        return f"SparseCSFTensor{self.shape} nnz={self.non_zero_length}"
