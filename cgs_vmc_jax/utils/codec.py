"""Msgpack codec for parameter and train-state pytrees.

Reads and writes exactly the format of `flax.serialization.to_bytes` /
`from_bytes`, so every committed `artifacts/*.msgpack` and existing run
directory loads, and a file written here is byte-identical to flax's for
the same pytree:

 * the pytree becomes a "state dict": dicts keep their key order with
   keys as str, lists and tuples become {"0": ..., "1": ...}, NamedTuples
   become {field: ...} in field order;
 * that is packed as msgpack maps with str keys, Python scalars as
   msgpack scalars (floats as float64), and array leaves as extension
   type 1 holding a nested msgpack array [shape, dtype name, C-order
   bytes] (numpy scalars as type 3, Python complex as type 2).

Arrays of more than 1 GiB (which flax splits into chunks) are refused.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import jax

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3
_MAX_ARRAY_BYTES = 2 ** 30


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, '_fields')


def to_state_dict(tree: Any) -> Any:
    """Containers -> nested str-keyed dicts; leaves unchanged."""
    if _is_namedtuple(tree):
        return {k: to_state_dict(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, dict):
        keys = [str(k) for k in tree]
        if len(set(keys)) != len(keys):
            raise ValueError(f'dict keys are not unique as strings: {keys}')
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def from_state_dict(template: Any, state: Any) -> Any:
    """Rebuilds `template`'s container structure with the leaves of
    `state` (a state dict as produced by `to_state_dict`)."""
    if _is_namedtuple(template):
        if set(state) != set(template._fields):
            raise ValueError(
                f'fields {sorted(state)} do not match '
                f'{type(template).__name__}{template._fields}')
        return type(template)(**{
            k: from_state_dict(getattr(template, k), state[k])
            for k in template._fields})
    if isinstance(template, dict):
        missing = {str(k) for k in template} - set(state)
        if missing:
            raise ValueError(f'state dict lacks keys {sorted(missing)}')
        return {k: from_state_dict(v, state[str(k)])
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(state) != len(template):
            raise ValueError(f'sequence of length {len(template)} vs '
                             f'{len(state)} entries')
        items = [from_state_dict(v, state[str(i)])
                 for i, v in enumerate(template)]
        return items if isinstance(template, list) else tuple(items)
    return state


# --- msgpack writer ------------------------------------------------------


def _pack_uint_header(out, n, small_tag, small_max, tags):
    """Length header: fix-format if n <= small_max, else 8/16/32-bit."""
    if n <= small_max and small_tag is not None:
        out.append(struct.pack('B', small_tag | n))
    elif n < 1 << 8 and tags[0] is not None:
        out.append(struct.pack('>BB', tags[0], n))
    elif n < 1 << 16:
        out.append(struct.pack('>BH', tags[1], n))
    elif n < 1 << 32:
        out.append(struct.pack('>BI', tags[2], n))
    else:
        raise ValueError(f'msgpack object of length {n} is too large')


def _pack_int(out, x):
    if 0 <= x < 128:
        out.append(struct.pack('B', x))
    elif -32 <= x < 0:
        out.append(struct.pack('b', x))
    elif x >= 0:
        for fmt, tag in (('>BB', 0xcc), ('>BH', 0xcd), ('>BI', 0xce),
                         ('>BQ', 0xcf)):
            try:
                out.append(struct.pack(fmt, tag, x))
                return
            except struct.error:
                continue
        raise OverflowError(f'{x} does not fit in uint64')
    else:
        for fmt, tag in (('>Bb', 0xd0), ('>Bh', 0xd1), ('>Bi', 0xd2),
                         ('>Bq', 0xd3)):
            try:
                out.append(struct.pack(fmt, tag, x))
                return
            except struct.error:
                continue
        raise OverflowError(f'{x} does not fit in int64')


def _pack_ext(out, code, data):
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(struct.pack('>Bb', fixed[n], code))
    else:
        _pack_uint_header(out, n, None, -1, (0xc7, 0xc8, 0xc9))
        out.append(struct.pack('b', code))
    out.append(data)


def _pack_array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError('object and structured dtypes are not supported')
    if arr.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError(f'array of {arr.nbytes} bytes exceeds 1 GiB')
    return _packb((tuple(arr.shape), arr.dtype.name, arr.tobytes('C')))


def _pack(out, x):
    # Exact-type dispatch, as msgpack's strict_types packer does.
    t = type(x)
    if x is None:
        out.append(b'\xc0')
    elif t is bool:
        out.append(b'\xc3' if x else b'\xc2')
    elif t is int:
        _pack_int(out, x)
    elif t is float:
        out.append(struct.pack('>Bd', 0xcb, x))
    elif t is str:
        data = x.encode('utf-8')
        _pack_uint_header(out, len(data), 0xa0, 31, (0xd9, 0xda, 0xdb))
        out.append(data)
    elif t is bytes:
        _pack_uint_header(out, len(x), None, -1, (0xc4, 0xc5, 0xc6))
        out.append(x)
    elif t in (list, tuple):
        _pack_uint_header(out, len(x), 0x90, 15, (None, 0xdc, 0xdd))
        for item in x:
            _pack(out, item)
    elif t is dict:
        _pack_uint_header(out, len(x), 0x80, 15, (None, 0xde, 0xdf))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (np.ndarray, jax.Array)):
        _pack_ext(out, _EXT_NDARRAY, _pack_array_payload(np.asarray(x)))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _pack_array_payload(np.asarray(x)))
    elif t is complex:
        _pack_ext(out, _EXT_COMPLEX, _packb((x.real, x.imag)))
    else:
        raise TypeError(f'cannot serialize {t.__name__}')


def _packb(x) -> bytes:
    out = []
    _pack(out, x)
    return b''.join(out)


# --- msgpack reader ------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError('truncated msgpack data')
        chunk = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        data = self.take(n)
        return data if self.raw else data.decode('utf-8')

    def ext(self, n: int):
        code = self.unpack('b')
        return _decode_ext(code, self.take(n))

    def read(self):
        tag = self.unpack('B')
        if tag <= 0x7f:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8f:
            return self.map_(tag & 0x0f)
        if 0x90 <= tag <= 0x9f:
            return [self.read() for _ in range(tag & 0x0f)]
        if 0xa0 <= tag <= 0xbf:
            return self.str_(tag & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if tag in simple:
            return simple[tag]
        scalars = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H',
                   0xce: '>I', 0xcf: '>Q', 0xd0: '>b', 0xd1: '>h',
                   0xd2: '>i', 0xd3: '>q'}
        if tag in scalars:
            return self.unpack(scalars[tag])
        lengths = {0xc4: '>B', 0xc5: '>H', 0xc6: '>I', 0xc7: '>B',
                   0xc8: '>H', 0xc9: '>I', 0xd9: '>B', 0xda: '>H',
                   0xdb: '>I', 0xdc: '>H', 0xdd: '>I', 0xde: '>H',
                   0xdf: '>I'}
        if tag in lengths:
            n = self.unpack(lengths[tag])
            if tag <= 0xc6:
                return self.take(n)
            if tag <= 0xc9:
                return self.ext(n)
            if tag <= 0xdb:
                return self.str_(n)
            if tag <= 0xdd:
                return [self.read() for _ in range(n)]
            return self.map_(n)
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if tag in fixext:
            return self.ext(fixext[tag])
        raise ValueError(f'unsupported msgpack tag 0x{tag:02x}')

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _unpackb(data: bytes, raw: bool):
    reader = _Reader(data, raw)
    value = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError('trailing bytes after msgpack object')
    return value


def _decode_array(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _unpackb(data, raw=True)
    dtype = (jax.numpy.bfloat16 if dtype_name == b'bfloat16'
             else np.dtype(dtype_name.decode()))
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order='C')


def _decode_ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _decode_array(data)
    if code == _EXT_NPSCALAR:
        return _decode_array(data)[()]
    if code == _EXT_COMPLEX:
        real, imag = _unpackb(data, raw=False)
        return complex(real, imag)
    raise ValueError(f'unknown msgpack extension type {code}')


# --- public API ----------------------------------------------------------


def to_bytes(tree: Any) -> bytes:
    """Serializes a host pytree (numpy or fully addressable jax leaves)."""
    return _packb(to_state_dict(tree))


def msgpack_restore(data: bytes) -> Any:
    """Decodes bytes into a raw state dict (nested dicts, array leaves)."""
    return _unpackb(data, raw=False)


def from_bytes(template: Any, data: bytes) -> Any:
    """Decodes bytes onto the container structure of `template`."""
    return from_state_dict(template, msgpack_restore(data))
