"""The JAX trainer's checkpoints without flax or msgpack.

``nbasr_tpu``'s ``Trainer.save`` writes ``flax.serialization.to_bytes`` of
``{'params', 'opt_state', 'step', 'rng'}``: msgpack, in the subset that
flax's ``msgpack_serialize`` / ``msgpack_restore`` use.  This module reads
and writes that subset itself, so a checkpoint crosses to and from a
machine that has neither package:

- maps with str keys, arrays, nil, bool, int, float, str and bin;
- ext 1 ``ndarray``: a msgpack array ``(shape, dtype name, row-major
  bytes)``; ext 3 ``npscalar``, the same for a numpy scalar; ext 2
  ``native_complex``: ``(real, imag)``;
- flax's ``{'__msgpack_chunked_array__': True, 'shape': ..., 'chunks':
  ...}`` maps, which arrays larger than :data:`MAX_CHUNK_SIZE` bytes
  become, joined back into one array.

Array payloads become ``np.frombuffer`` views of the file's bytes (a
chunked array one copy); nothing walks them byte by byte.  A truncated
file, trailing bytes, or a type, ext code or dtype outside the subset
raise ``ValueError`` naming the offset.

:func:`load_flax` is the port's counterpart of the JAX ``Trainer.load``
and :func:`save_flax` of its ``save``.  The optimizer state the JAX trainer
writes is ``optax.apply_if_finite`` around ``chain(clip, scale_by_adam,
scale)``: ``{'notfinite_count', 'last_finite', 'total_notfinite',
'inner_state': {'0': {}, '1': {'count', 'mu', 'nu'}, '2': {}}}``.  Adam's
``count``, ``mu`` and ``nu`` become ``torch.optim.Adam``'s ``step``,
``exp_avg`` and ``exp_avg_sq`` of each parameter, by
:mod:`nbasr_torch.convert`'s name map and layout change.
"""

import json
import pathlib
import struct

import numpy as np
import torch

from .convert import adam_from_flax, adam_to_flax, from_flax, to_flax

__all__ = ['MAX_CHUNK_SIZE', 'packb', 'unpackb', 'is_flax_checkpoint',
           'load_flax', 'save_flax', 'jax_key_data']

#: Arrays larger than this many bytes are written as flax's chunked maps
#: (``flax/serialization.py``'s ``MAX_CHUNK_SIZE``: msgpack caps one
#: object at 2**31 - 1 bytes).
MAX_CHUNK_SIZE = 2 ** 30

_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3
_CHUNKED = '__msgpack_chunked_array__'
#: dtype names an array may carry: numpy's plain numeric types, and
#: bfloat16 (read into a torch tensor: numpy has no such type).
_DTYPES = frozenset((
    'bool', 'int8', 'int16', 'int32', 'int64', 'uint8', 'uint16', 'uint32',
    'uint64', 'float16', 'float32', 'float64', 'complex64', 'complex128',
    'bfloat16'))


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class _Reader:
    """Recursive descent over one msgpack object from ``data[pos:]``."""

    def __init__(self, data, base=0, views=False):
        self.data = data
        self.pos = 0
        self.base = base            # offset of ``data`` in the file
        self.views = views          # bin as a view of ``data``, not bytes

    def fail(self, what, at=None):
        at = self.pos if at is None else at
        raise ValueError(f'flax checkpoint: {what} at offset {self.base + at}')

    def take(self, n):
        end = self.pos + n
        if end > len(self.data):
            self.fail(f'truncated: {n} bytes wanted, '
                      f'{len(self.data) - self.pos} left')
        lo, self.pos = self.pos, end
        return lo

    def uint(self, n):
        lo = self.take(n)
        return int.from_bytes(self.data[lo:lo + n], 'big')

    def read(self):
        start = self.pos
        b = self.data[self.take(1)]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f, start)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):
            n = self.uint(1 << (b - 0xc4))
            lo = self.take(n)
            view = self.data[lo:lo + n]
            return view if self.views else bytes(view)
        if b in (0xc7, 0xc8, 0xc9):
            return self.ext(self.uint(1 << (b - 0xc7)), start)
        if b == 0xca:
            return struct.unpack('>f', self.data[self.take(4):self.pos])[0]
        if b == 0xcb:
            return struct.unpack('>d', self.data[self.take(8):self.pos])[0]
        if 0xcc <= b <= 0xcf:
            return self.uint(1 << (b - 0xcc))
        if 0xd0 <= b <= 0xd3:
            n = 1 << (b - 0xd0)
            lo = self.take(n)
            return int.from_bytes(self.data[lo:lo + n], 'big', signed=True)
        if 0xd4 <= b <= 0xd8:
            return self.ext(1 << (b - 0xd4), start)
        if b in (0xd9, 0xda, 0xdb):
            return self.str(self.uint(1 << (b - 0xd9)))
        if b in (0xdc, 0xdd):
            return self.array(self.uint(2 << (b - 0xdc)))
        if b in (0xde, 0xdf):
            return self.map(self.uint(2 << (b - 0xde)), start)
        self.fail(f'type byte 0x{b:02x} outside the subset', start)

    def str(self, n):
        lo = self.take(n)
        try:
            return bytes(self.data[lo:lo + n]).decode('utf-8')
        except UnicodeDecodeError:
            self.fail('a str that is not UTF-8', lo)

    def array(self, n):
        return [self.read() for _ in range(n)]

    def map(self, n, start):
        out = {}
        for _ in range(n):
            at = self.pos
            key = self.read()
            if not isinstance(key, str):
                self.fail(f'a map key of type {type(key).__name__}', at)
            out[key] = self.read()
        if out.get(_CHUNKED) is True:
            return self.unchunk(out, start)
        return out

    def ext(self, n, start):
        code = struct.unpack('b', self.data[self.take(1):self.pos])[0]
        lo = self.take(n)
        if code == _NDARRAY:
            return self.ndarray(lo, n, start)
        if code == _NPSCALAR:
            return self.ndarray(lo, n, start)[()]
        if code == _COMPLEX:
            inner = _Reader(self.data[lo:lo + n], self.base + lo)
            parts = inner.read()
            inner.end()
            if (not isinstance(parts, list) or len(parts) != 2 or not all(
                    isinstance(p, (int, float)) for p in parts)):
                self.fail('a complex ext that is not (real, imag)', start)
            return complex(*parts)
        self.fail(f'ext code {code} outside the subset', start)

    def ndarray(self, lo, n, start):
        inner = _Reader(self.data[lo:lo + n], self.base + lo, views=True)
        head = inner.read()
        inner.end()
        if (not isinstance(head, list) or len(head) != 3
                or not isinstance(head[0], list)
                or not all(isinstance(d, int) and d >= 0 for d in head[0])
                or not isinstance(head[2], (bytes, memoryview))):
            self.fail('an ndarray ext that is not (shape, dtype, bytes)', start)
        shape, name, buf = head
        name = bytes(name).decode() if isinstance(name, (bytes, memoryview)) \
            else name
        if name not in _DTYPES:
            self.fail(f'dtype {name!r} outside the subset', start)
        count = int(np.prod(shape, dtype=np.int64))
        itemsize = 2 if name == 'bfloat16' else np.dtype(name).itemsize
        if len(buf) != count * itemsize:
            self.fail(f'an ndarray of shape {tuple(shape)} {name} with '
                      f'{len(buf)} bytes', start)
        if name == 'bfloat16':
            raw = np.frombuffer(buf, np.uint16, count).reshape(shape)
            return torch.from_numpy(raw.copy()).view(torch.bfloat16)
        return np.frombuffer(buf, np.dtype(name), count).reshape(shape)

    def unchunk(self, node, start):
        try:
            shape = [node['shape'][str(i)] for i in range(len(node['shape']))]
            chunks = [node['chunks'][str(i)]
                      for i in range(len(node['chunks']))]
            flat = np.concatenate([np.asarray(c).reshape(-1) for c in chunks])
            return flat.reshape(shape)
        except (KeyError, TypeError, ValueError) as e:
            self.fail(f'a malformed chunked array ({e})', start)

    def end(self):
        if self.pos != len(self.data):
            self.fail(f'{len(self.data) - self.pos} trailing bytes')


def unpackb(data):
    """One msgpack object of flax's subset from ``data`` (bytes): dicts,
    lists, Python scalars, bytes, numpy arrays (read-only views of
    ``data``) and numpy scalars; chunked arrays joined."""
    reader = _Reader(memoryview(data))
    out = reader.read()
    reader.end()
    return out


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _uint_head(n, small, codes):
    """A length header: ``small`` (a fix-format base and its limit) when it
    fits, else the 8/16/32-bit form of ``codes``."""
    base, limit = small
    if base is not None and n < limit:
        return bytes((base | n,))
    for code, width in zip(codes, (1, 2, 4)):
        if code is not None and n < 1 << (8 * width):
            return bytes((code,)) + n.to_bytes(width, 'big')
    raise ValueError(f'flax checkpoint: a length of {n} does not fit msgpack')


def _int(v):
    if 0 <= v < 0x80 or -32 <= v < 0:
        return struct.pack('b' if v < 0 else 'B', v)
    if v >= 0:
        for code, fmt in ((0xcc, 'B'), (0xcd, '>H'), (0xce, '>I'),
                          (0xcf, '>Q')):
            if v < 1 << (8 * struct.calcsize(fmt)):
                return bytes((code,)) + struct.pack(fmt, v)
    else:
        for code, fmt in ((0xd0, 'b'), (0xd1, '>h'), (0xd2, '>i'),
                          (0xd3, '>q')):
            if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                return bytes((code,)) + struct.pack(fmt, v)
    raise ValueError(f'flax checkpoint: int {v} does not fit msgpack')


def _str(s):
    raw = s.encode('utf-8')
    return _uint_head(len(raw), (0xa0, 32), (0xd9, 0xda, 0xdb)) + raw


def _ext(code, payload_parts):
    n = sum(len(p) for p in payload_parts)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        head = bytes((fixed[n],))
    else:
        head = _uint_head(n, (None, 0), (0xc7, 0xc8, 0xc9))
    return [head + struct.pack('b', code), *payload_parts]


def _ndarray_parts(arr):
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype name, bytes))``,
    the bytes as a view of the (C-contiguous) array."""
    arr = np.asarray(arr, order='C')      # (ascontiguousarray makes 0-d 1-d)
    if arr.dtype.name not in _DTYPES:
        raise ValueError(f'flax checkpoint: dtype {arr.dtype} is outside the '
                         f'subset')
    head = b'\x93' + _uint_head(len(arr.shape), (0x90, 16), (None, 0xdc, 0xdd))
    head += b''.join(_int(int(d)) for d in arr.shape) + _str(arr.dtype.name)
    head += _uint_head(arr.nbytes, (None, 0), (0xc4, 0xc5, 0xc6))
    return [head, memoryview(arr.reshape(-1)).cast('B')]


def _chunk(arr):
    """flax's ``_chunk``: an array over :data:`MAX_CHUNK_SIZE` bytes as a
    map of flat chunks."""
    size = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
    flat = np.ascontiguousarray(arr).reshape(-1)
    return {_CHUNKED: True,
            'shape': {str(i): int(d) for i, d in enumerate(arr.shape)},
            'chunks': {str(i): flat[lo:lo + size] for i, lo in
                       enumerate(range(0, flat.size, size))}}


def _pack(obj, out):
    if obj is None:
        out.append(b'\xc0')
    elif obj is True or obj is False:
        out.append(b'\xc3' if obj else b'\xc2')
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(b'\xcb' + struct.pack('>d', obj))
    elif type(obj) is str:
        out.append(_str(obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        out += [_uint_head(len(obj), (None, 0), (0xc4, 0xc5, 0xc6)), obj]
    elif isinstance(obj, dict):
        if not all(type(k) is str for k in obj):
            raise ValueError(f'flax checkpoint: a map key of {list(obj)} is '
                             f'not a str')
        out.append(_uint_head(len(obj), (0x80, 16), (None, 0xde, 0xdf)))
        for k, v in obj.items():
            out.append(_str(k))
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_uint_head(len(obj), (0x90, 16), (None, 0xdc, 0xdd)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > MAX_CHUNK_SIZE:
            _pack(_chunk(obj), out)
        else:
            out += _ext(_NDARRAY, _ndarray_parts(obj))
    elif isinstance(obj, np.generic):
        out += _ext(_NPSCALAR, _ndarray_parts(np.asarray(obj)))
    elif type(obj) is complex:
        out += _ext(_COMPLEX, [b'\x92\xcb' + struct.pack('>d', obj.real)
                               + b'\xcb' + struct.pack('>d', obj.imag)])
    else:
        raise ValueError(f'flax checkpoint: {type(obj).__name__} is outside '
                         f'the subset')


def _parts(obj):
    out = []
    _pack(obj, out)
    return out


def packb(obj):
    """``obj`` (dicts with str keys, lists, Python scalars, bytes, numpy
    arrays and scalars, complex) as flax's ``to_bytes`` writes it
    (``msgpack_serialize(..., in_place=True)``): maps in their own order."""
    return b''.join(_parts(obj))


# ---------------------------------------------------------------------------
# the JAX trainer's checkpoint
# ---------------------------------------------------------------------------

def is_flax_checkpoint(head):
    """Whether a file's first bytes open a msgpack map (a flax checkpoint)."""
    return len(head) > 0 and (0x80 <= head[0] <= 0x8f or head[0] in (0xde,
                                                                     0xdf))


def jax_key_data(seed, impl='rbg'):
    """``jax.random.key_data(jax.random.key(seed, impl=impl))`` for a seed
    in ``[0, 2**32)``: threefry's key is ``[0, seed]`` (uint32), rbg's and
    unsafe_rbg's that pair twice."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f'seed {seed} is outside [0, 2**32)')
    half = [0, seed]
    if impl == 'threefry2x32':
        return np.asarray(half, np.uint32)
    if impl in ('rbg', 'unsafe_rbg'):
        return np.asarray(half * 2, np.uint32)
    raise ValueError(f'unknown JAX PRNG impl: {impl!r}')


def _adam_state(opt_state, at):
    """The ``scale_by_adam`` state in the JAX trainer's
    ``apply_if_finite(chain(...))`` state."""
    inner = opt_state.get('inner_state') if isinstance(opt_state, dict) \
        else None
    found = [s for s in (inner or {}).values()
             if isinstance(s, dict) and {'count', 'mu', 'nu'} <= set(s)]
    if len(found) != 1:
        raise ValueError(f'{at}: no optax Adam state (count, mu, nu) in '
                         f"opt_state['inner_state']")
    return found[0]


def _by_parameter(shapes, state, what, at):
    """A state dict as one tensor per parameter of the whole model
    (``shapes``: ``{name: shape}``); every parameter must be there, and
    nothing else."""
    if state.keys() != shapes.keys():
        raise ValueError(
            f'{at}: {what} does not fit the model: missing '
            f'{sorted(shapes.keys() - state.keys())}, unexpected '
            f'{sorted(state.keys() - shapes.keys())}')
    for name, shape in shapes.items():
        if tuple(state[name].shape) != tuple(shape):
            raise ValueError(f'{at}: {what} {name} has shape '
                             f'{tuple(state[name].shape)}, the model '
                             f'{tuple(shape)}')
    return {name: state[name] for name in shapes}


def _parameter_order(trainer):
    """The model's parameter names in the optimizer's order."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    return [names[id(p)] for g in trainer.optimizer.param_groups
            for p in g['params']]


def load_flax(trainer, path):
    """Restore a checkpoint the JAX ``Trainer.save`` wrote into the port's
    ``trainer`` (its model and Adam built by ``init_state``); returns the
    ``.json`` sidecar's meta, as :meth:`Trainer.load` does.

    ``params`` go through :func:`~nbasr_torch.convert.from_flax`; Adam's
    ``count``/``mu``/``nu`` become each parameter's
    ``step``/``exp_avg``/``exp_avg_sq``; ``step`` becomes ``step_count`` and
    ``total_notfinite`` ``nonfinite_steps``.  ``rng`` is read and not used:
    the JAX trainer's dropout stream (``jax.random`` keys) and the port's
    (a ``torch.Generator``) are different streams, so the trainer's
    generator is left as it is.  The whole model's state goes through
    ``trainer.load_full_state``, so a tensor-parallel trainer takes its
    slices."""
    path = pathlib.Path(path)
    raw = unpackb(path.read_bytes())
    at = str(path)
    if not isinstance(raw, dict) or not {'params', 'opt_state', 'step',
                                         'rng'} <= set(raw):
        raise ValueError(f'{at}: not a JAX trainer checkpoint (keys '
                         f'{sorted(raw) if isinstance(raw, dict) else type(raw)})')
    shapes = trainer.full_shapes()
    count, mu, nu = adam_from_flax(_adam_state(raw['opt_state'], at))
    params = _by_parameter(shapes, from_flax({'params': raw['params']}),
                           'params', at)
    mu = _by_parameter(shapes, mu, 'Adam mu', at)
    nu = _by_parameter(shapes, nu, 'Adam nu', at)
    state = {i: {'step': torch.tensor(float(count)),
                 'exp_avg': mu[name].clone(), 'exp_avg_sq': nu[name].clone()}
             for i, name in enumerate(_parameter_order(trainer))}
    buffers = dict(trainer.model.named_buffers())
    trainer.load_full_state(
        {**buffers, **params},
        {'state': state,
         'param_groups': trainer.optimizer.state_dict()['param_groups']})
    trainer.step_count = int(raw['step'])
    trainer.nonfinite_steps = int(raw['opt_state']['total_notfinite'])
    trainer.nonfinite_run = int(raw['opt_state'].get('notfinite_count', 0))
    meta_file = path.with_suffix(path.suffix + '.json')
    return json.loads(meta_file.read_text()) if meta_file.exists() else {}


def _sorted(tree):
    return {k: _sorted(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def save_flax(trainer, path, rng_impl='rbg', **meta):
    """Write what the JAX ``Trainer.save`` writes from the port's
    ``trainer``, and ``meta`` to ``path + '.json'``, so that the JAX
    ``Trainer.load`` restores it.  Adam's moments and step go to
    ``mu``/``nu``/``count``; a parameter Adam has not stepped gets zeros.
    ``rng`` is the JAX key data of ``seed + 1`` (the JAX trainer's initial
    dropout key) for ``rng_impl``, the JAX trainer's default ``'rbg'``
    giving uint32 ``[4]`` (``'threefry2x32'`` ``[2]``): the port's
    generator state has no JAX counterpart.  The whole model's state comes
    from ``trainer.full_state``: every process of a parallel run calls
    this, and the lead one writes."""
    path = pathlib.Path(path)
    model_state, opt_state = trainer.full_state()
    if not getattr(trainer, 'is_lead', True):
        return
    params, mu, nu = {}, {}, {}
    count = 0
    for i, name in enumerate(_parameter_order(trainer)):
        p = params[name] = model_state[name]
        st = opt_state['state'].get(i, {})
        if st:
            count = max(count, int(st['step']))
        mu[name] = st.get('exp_avg', torch.zeros_like(p))
        nu[name] = st.get('exp_avg_sq', torch.zeros_like(p))
    run = int(getattr(trainer, 'nonfinite_run', 0))
    adam = adam_to_flax(count, mu, nu)
    adam.update(mu=_sorted(adam['mu']), nu=_sorted(adam['nu']))
    tree = {    # in the order of the JAX trainer's file (params sorted)
        'params': _sorted(to_flax(params)['params']),
        'opt_state': {
            'notfinite_count': np.asarray(run, np.int32),
            'last_finite': np.asarray(run == 0),
            'total_notfinite': np.asarray(trainer.nonfinite_steps, np.int32),
            'inner_state': {'0': {}, '1': adam, '2': {}}},
        'step': np.asarray(trainer.step_count, np.int32),
        'rng': jax_key_data(trainer.seed + 1, rng_impl)}
    with open(path, 'wb') as f:
        for part in _parts(tree):
            f.write(part)
    path.with_suffix(path.suffix + '.json').write_text(json.dumps(meta))
