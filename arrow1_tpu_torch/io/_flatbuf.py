"""A small FlatBuffers builder: the part of the format the IPC and Feather
V1 writers use (tables with scalar and offset slots, strings, vectors of
scalars, offsets and structs), with the ``flatbuffers`` package's method
names, so the writers read as the JAX package's do without needing that
package (the card machine does not have it).

The buffer is built back to front, as the format's reference builders
build it: ``Offset()`` counts bytes from the end, every scalar is aligned
to its size, a table's vtable is written after the table and shared with
an earlier table that has the same one. ``Output()`` after ``Finish``
gives the bytes.
"""

from __future__ import annotations

import struct

__all__ = ["Builder"]

_FMT = {"b": 1, "B": 1, "?": 1, "h": 2, "H": 2, "i": 4, "I": 4, "q": 8,
        "Q": 8}


class Builder:
    def __init__(self, initial_size: int = 1024):
        self.Bytes = bytearray(max(initial_size, 1))
        self.head = len(self.Bytes)
        self.minalign = 1
        self.current_vtable = None
        self.object_end = 0
        self.vtables = {}
        self.vector_len = 0
        self.finished = False

    # -- raw placement ----------------------------------------------------
    def Offset(self) -> int:
        return len(self.Bytes) - self.head

    def _grow(self) -> None:
        new = bytearray(2 * len(self.Bytes))
        new[len(new) - len(self.Bytes):] = self.Bytes
        self.head += len(new) - len(self.Bytes)
        self.Bytes = new

    def Pad(self, n: int) -> None:
        if n > 0:
            self.head -= n
            self.Bytes[self.head:self.head + n] = bytes(n)

    def Prep(self, size: int, additional: int) -> None:
        """Align so that a ``size``-byte scalar written after
        ``additional`` more bytes lands on a multiple of ``size``."""
        self.minalign = max(self.minalign, size)
        align = (-(len(self.Bytes) - self.head + additional)) & (size - 1)
        while self.head < align + size + additional:
            self._grow()
        self.Pad(align)

    def _place(self, fmt: str, x) -> None:
        self.head -= _FMT[fmt]
        struct.pack_into("<" + fmt, self.Bytes, self.head, x)

    def _prepend(self, fmt: str, x) -> None:
        self.Prep(_FMT[fmt], 0)
        self._place(fmt, x)

    def PrependInt8(self, x):
        self._prepend("b", x)

    def PrependInt32(self, x):
        self._prepend("i", x)

    def PrependInt64(self, x):
        self._prepend("q", x)

    def PrependUOffsetTRelative(self, off: int) -> None:
        self.Prep(4, 0)
        if off > self.Offset():
            raise ValueError("flatbuffer offset arithmetic error")
        self._place("I", self.Offset() - off + 4)

    # -- tables -----------------------------------------------------------
    def StartObject(self, numfields: int) -> None:
        self.current_vtable = [0] * numfields
        self.object_end = self.Offset()

    def _slot(self, fmt: str, slot: int, x, default) -> None:
        if x != default:
            self._prepend(fmt, x)
            self.current_vtable[slot] = self.Offset()

    def PrependBoolSlot(self, slot, x, default):
        self._slot("?", slot, bool(x), bool(default))

    def PrependInt8Slot(self, slot, x, default):
        self._slot("b", slot, x, default)

    def PrependUint8Slot(self, slot, x, default):
        self._slot("B", slot, x, default)

    def PrependInt16Slot(self, slot, x, default):
        self._slot("h", slot, x, default)

    def PrependInt32Slot(self, slot, x, default):
        self._slot("i", slot, x, default)

    def PrependInt64Slot(self, slot, x, default):
        self._slot("q", slot, x, default)

    def PrependUOffsetTRelativeSlot(self, slot, off, default):
        if off != default:
            self.PrependUOffsetTRelative(off)
            self.current_vtable[slot] = self.Offset()

    def EndObject(self) -> int:
        """Write the table's vtable offset and its vtable (or point it at
        an equal one written before); returns the table's offset."""
        self._prepend("i", 0)
        obj = self.Offset()
        fields = list(self.current_vtable)
        while fields and fields[-1] == 0:
            fields.pop()
        entries = [obj - f if f else 0 for f in fields]
        key = (tuple(entries), obj - self.object_end)
        found = self.vtables.get(key)
        start = len(self.Bytes) - obj
        if found is None:
            for e in reversed(entries):
                self._prepend("H", e)
            self._prepend("H", obj - self.object_end)
            self._prepend("H", 2 * (len(entries) + 2))
            struct.pack_into("<i", self.Bytes, start, self.Offset() - obj)
            self.vtables[key] = self.Offset()
        else:
            struct.pack_into("<i", self.Bytes, start, found - obj)
        self.current_vtable = None
        return obj

    # -- vectors and strings ----------------------------------------------
    def StartVector(self, elem_size: int, num_elems: int,
                    alignment: int) -> int:
        self.vector_len = num_elems
        self.Prep(4, elem_size * num_elems)
        self.Prep(alignment, elem_size * num_elems)
        return self.Offset()

    def EndVector(self) -> int:
        self._place("I", self.vector_len)
        return self.Offset()

    def CreateString(self, s) -> int:
        x = s.encode("utf-8") if isinstance(s, str) else bytes(s)
        self.Prep(4, len(x) + 1)
        self._place("B", 0)
        self.head -= len(x)
        self.Bytes[self.head:self.head + len(x)] = x
        self.vector_len = len(x)
        return self.EndVector()

    # -- finishing --------------------------------------------------------
    def Finish(self, root: int) -> int:
        self.Prep(self.minalign, 4)
        self.PrependUOffsetTRelative(root)
        self.finished = True
        return self.head

    def Output(self) -> bytes:
        if not self.finished:
            raise ValueError("flatbuffer not finished")
        return bytes(self.Bytes[self.head:])
