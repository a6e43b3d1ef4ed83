"""The feature-probe matrix on Hopper (counterpart of
arrow1_tpu/kernels/tpu_probes.py). Run it on a GPU:

    python -m arrow1_tpu_torch.kernels.probes

Each probe launches one small kernel of ``csrc/probes.cu`` on the
reference's inputs (``x1 = arange(4096)`` int32, ``x2 = arange(4096)``
as [32, 128]) and compares its output with the probe's plain PyTorch
version. The report is the reference's: probe name -> "OK", or
"FAIL: <message>"; "OK" means the kernel launched and its output equals
the plain version's. The two bitcast probes of the reference are
``jax.jit`` programs, not kernels; here they are ``Tensor.view``s,
checked against their expected values.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict

import numpy as np
import torch

from . import build

__all__ = ["PROBES", "probe_inputs", "plain", "run_probe", "run_probes",
           "SOURCE"]

SOURCE = "probes.cu"
R, L, T = 8, 128, 1024   # a 2-D tile is [R, L]; a 1-D block is T

# probe name -> (C entry point, its input: "x1" or "x2")
PROBES = {
    "blocked-1d": ("a1t_probe_blocked_1d", "x1"),
    "blocked-2d": ("a1t_probe_blocked_2d", "x2"),
    "manual-dma-matmul": ("a1t_probe_dma_matmul", "x2"),
    "cumsum-1d": ("a1t_probe_cumsum_1d", "x1"),
    "smem-output": ("a1t_probe_smem_output", "x1"),
    "dma-in-when": ("a1t_probe_dma_in_when", "x2"),
}


def probe_inputs(device) -> Dict[str, torch.Tensor]:
    """The reference's inputs: x1 = arange(4T) int32, x2 = arange(4RL)
    int32 as [4R, L]."""
    x1 = torch.arange(4 * T, dtype=torch.int32, device=device)
    x2 = torch.arange(4 * R * L, dtype=torch.int32,
                      device=device).reshape(4 * R, L)
    return {"x1": x1, "x2": x2}


def _even_tiles(x: torch.Tensor) -> torch.Tensor:
    tiles = x.reshape(-1, R, L)
    keep = (torch.arange(tiles.shape[0], device=x.device) % 2 == 0)
    return torch.where(keep[:, None, None], tiles, 0).reshape(x.shape)


# probe name -> plain PyTorch version of what its kernel computes
_PLAIN: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "blocked-1d": lambda x: x * 2,
    "blocked-2d": lambda x: x * 2,
    # the reference's (x % 2) @ tri with tri[k, j] = k <= j
    "manual-dma-matmul": lambda x: torch.cumsum(torch.remainder(x, 2), 1,
                                                dtype=torch.int32),
    "cumsum-1d": lambda x: torch.cumsum(x, 0, dtype=torch.int32),
    "smem-output": lambda x: x.sum(dtype=torch.int32).reshape(1),
    # odd tiles are never written by the reference (undefined there); the
    # port's output starts zeroed, so they read 0
    "dma-in-when": _even_tiles,
}


def plain(name: str, x: torch.Tensor) -> torch.Tensor:
    """Probe ``name``'s plain PyTorch version."""
    return _PLAIN[name](x)


@functools.cache
def _lib():
    lib = build.load(SOURCE)
    for entry, _ in PROBES.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def run_probe(name: str, x: torch.Tensor) -> torch.Tensor:
    """Launch probe ``name``'s kernel on the int32 tensor ``x`` (CUDA) and
    return its output; a CPU tensor runs the plain version. Counts the
    kernel's launches in ``run_probe.launches[name]``."""
    entry, kind = PROBES[name]
    if x.dtype != torch.int32:
        raise TypeError(f"probe {name}: int32 input expected, got {x.dtype}")
    if kind == "x2" and (x.dim() != 2 or x.shape[1] != L
                         or x.shape[0] % R):
        raise ValueError(f"probe {name}: input must be [8k, {L}], got "
                         f"{tuple(x.shape)}")
    if kind == "x1" and x.dim() != 1:
        raise ValueError(f"probe {name}: input must be 1-D")
    if x.device.type == "cpu":
        return plain(name, x)
    if x.device.type != "cuda":
        raise TypeError(f"probe {name}: no kernel for device {x.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:   # the 2-D probes copy 16 bytes a thread
        x = x.clone()
    if name == "smem-output":
        out = torch.empty(1, dtype=torch.int32, device=x.device)
    elif name == "dma-in-when":
        # odd tiles are never written: they keep these zeros
        out = torch.zeros_like(x)
    else:
        out = torch.empty_like(x)
    err = getattr(_lib(), entry)(x.data_ptr(), x.shape[0], out.data_ptr(),
                                 torch.cuda.current_stream(
                                     x.device).cuda_stream)
    if err:
        raise RuntimeError(f"probe {name}: kernel launch failed: CUDA error "
                           f"{err}")
    run_probe.launches[name] += 1
    return out


run_probe.launches = dict.fromkeys(PROBES, 0)


def _bitcast_probes(device) -> Dict[str, Callable[[], bool]]:
    """The reference's two jax.jit bitcasts as Tensor.views, each checked
    against numpy's view of the same values."""
    i64 = np.array([1, -2], dtype=np.int64)
    f64 = np.array([1.5, -2.5], dtype=np.float64)

    def check(values, dtype, np_dtype):
        got = torch.from_numpy(values).to(device).view(dtype).cpu().numpy()
        return bool(np.array_equal(got, values.view(np_dtype)))

    return {"bitcast-i64-i32x2": lambda: check(i64, torch.int32, np.int32),
            "bitcast-f64-i64": lambda: check(f64, torch.int64, np.int64)}


def run_probes(device=None) -> Dict[str, str]:
    """Run every probe on ``device`` (CUDA unless the caller names
    another); returns name -> "OK" or "FAIL: <first line of the error>"."""
    from ..device import resolve_device

    dev = resolve_device(device)
    xs = probe_inputs(dev)
    results: Dict[str, str] = {}

    def record(name, ok_fn):
        try:
            ok = ok_fn()
            results[name] = "OK" if ok else \
                "FAIL: output differs from the plain version"
        except (RuntimeError, TypeError, ValueError, OSError) as e:
            results[name] = f"FAIL: {str(e).splitlines()[0][:120]}"

    for name, (_, kind) in PROBES.items():
        x = xs[kind]

        def launched_and_equal(name=name, x=x):
            before = run_probe.launches[name]
            got = run_probe(name, x)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                if run_probe.launches[name] != before + 1:
                    raise RuntimeError("the kernel was not launched")
            return torch.equal(got, plain(name, x))

        record(name, launched_and_equal)
    for name, fn in _bitcast_probes(dev).items():
        record(name, fn)
    return results


if __name__ == "__main__":
    for probe_name, result in run_probes().items():
        print(f"{probe_name:<28} {result}")
