"""Multi-adapter (LoRA) serving, the port of
``mxnet_tpu/serving/adapters/__init__.py``: many low-rank fine-tunes of
one frozen base, served by the same captured decode programs.

The variant a sequence decodes under is an int32 per slot in the
programs' input buffer; the adapters themselves sit in a device-resident
pool the programs read:

  * :func:`save_adapter` / :func:`load_adapter`: the
    ``mxnet_tpu.adapter.v1`` artifact (``MANIFEST.json`` + ``params.npz``,
    blake2b-digested, so a corrupt artifact is a typed load error). The
    format is the JAX package's byte for byte: each package reads what the
    other writes, which is how adapter weights cross between them;
  * :class:`AdapterSpec`: the pool geometry a decode program is built
    for (targets, rank, capacity);
  * :class:`AdapterPool`: per target one ``(capacity, r, in)`` A stack and
    one ``(capacity, out, r)`` B stack on the device. Row 0 is the
    reserved all-zero base. A load writes its row **in place** (the scale
    folded into B), so the captured programs, bound to these tensors, read
    the new contents at their next replay; loads deduplicate by digest and
    refcount, LRU evicts unpinned rows, and a pool whose rows are all
    pinned raises :class:`AdapterExhaustedError` (a
    :class:`~..batcher.BackpressureError`);
  * :class:`AdapterRegistry`: request adapter ids resolved to pool rows,
    from registered adapters or lazily from artifact directories.

Loading, evicting and switching adapters never builds a program: the
pool's shapes are fixed when the program is. A cold load counts
``mxnet_tpu_serve_adapter_loads_total``, sets
``mxnet_tpu_serve_active_adapters`` to the resident rows and records
``adapter_load``; a load that evicted a row first counts
``mxnet_tpu_serve_adapter_evictions_total`` and records ``adapter_evict``
(the reference's ``adapters/__init__.py:435-447``).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import threading
import zipfile

import numpy as onp
import torch

from ...context import resolve_device
from ...observability import emit as _emit
from ..batcher import BackpressureError

__all__ = ['ADAPTER_SCHEMA', 'Adapter', 'AdapterSpec', 'AdapterPool',
           'AdapterRegistry', 'AdapterExhaustedError', 'init_adapter',
           'save_adapter', 'load_adapter']

ADAPTER_SCHEMA = 'mxnet_tpu.adapter.v1'


class AdapterExhaustedError(BackpressureError):
    """Every pool row is pinned by an in-flight sequence and none can be
    evicted: shed the request or retry, as for a full queue or an
    exhausted page pool."""

    def __init__(self, resident, capacity):
        RuntimeError.__init__(
            self, 'adapter pool exhausted (%d/%d entries pinned); shed load '
            'or retry with backoff' % (resident, capacity))
        self.depth = resident
        self.limit = capacity


# -- the mxnet_tpu.adapter.v1 artifact ----------------------------------------


def _digest(manifest, arrays):
    """blake2b-16 over the canonical manifest (without the digest) and
    every array's name, shape, dtype and bytes in sorted name order."""
    core = {k: v for k, v in manifest.items() if k != 'digest'}
    h = hashlib.blake2b(digest_size=16)
    h.update(json.dumps(core, sort_keys=True, separators=(',', ':')).encode())
    for name in sorted(arrays):
        arr = onp.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _write_atomic(path, payload):
    """``payload`` to ``path`` through a temporary file, fsync and an
    atomic rename."""
    tmp = '%s.tmp.%d' % (path, os.getpid())
    with open(tmp, 'wb') as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    try:
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class Adapter:
    """One ``mxnet_tpu.adapter.v1`` adapter: ``arrays`` maps
    ``l{i}_{target}_a`` -> (r, in) and ``l{i}_{target}_b`` -> (out, r)
    float32 arrays; ``scale`` multiplies the delta (folded into B when the
    pool loads it)."""

    __slots__ = ('name', 'rank', 'scale', 'arrays', 'digest')

    def __init__(self, name, rank, scale, arrays, digest):
        self.name = str(name)
        self.rank = int(rank)
        self.scale = float(scale)
        self.arrays = dict(arrays)
        self.digest = str(digest)

    def targets(self):
        """``{'l0_qkv': (out, in), ...}`` recovered from the arrays."""
        out = {}
        for key, arr in self.arrays.items():
            if key.endswith('_b'):
                out[key[:-2]] = (int(arr.shape[0]),
                                 int(self.arrays[key[:-1] + 'a'].shape[1]))
        return out

    def __repr__(self):
        return 'Adapter(%r, rank=%d, digest=%s)' % (self.name, self.rank,
                                                    self.digest[:8])


def init_adapter(model, rank, seed=0, scale=1.0, name=None, targets=None):
    """A deterministic random adapter for ``model`` (tests and benches),
    the reference's draws from a numpy ``RandomState(seed)``: A and B both
    nonzero, so the delta moves the logits. Returns an unsaved
    :class:`Adapter`."""
    per_layer = model.lora_targets()
    if targets is not None:
        per_layer = {t: per_layer[t] for t in targets}
    rs = onp.random.RandomState(seed)
    arrays = {}
    for i in range(model.layers):
        for t, (out, inp) in per_layer.items():
            arrays['l%d_%s_a' % (i, t)] = \
                (rs.randn(rank, inp) * 0.05).astype('float32')
            arrays['l%d_%s_b' % (i, t)] = \
                (rs.randn(out, rank) * 0.05).astype('float32')
    name = name or 'adapter-seed%d' % seed
    manifest = {'schema': ADAPTER_SCHEMA, 'name': name,
                'family': model.family, 'rank': int(rank),
                'scale': float(scale)}
    return Adapter(name, rank, scale, arrays, _digest(manifest, arrays))


def save_adapter(path, adapter, family='transformer_lm'):
    """Write the artifact directory: ``<path>/MANIFEST.json`` (schema,
    name, family, rank, scale, digest) and ``<path>/params.npz`` (the
    ``l{i}_{target}_{a,b}`` float32 arrays). Returns ``path``."""
    os.makedirs(path, exist_ok=True)
    manifest = {'schema': ADAPTER_SCHEMA, 'name': adapter.name,
                'family': family, 'rank': adapter.rank,
                'scale': adapter.scale}
    manifest['digest'] = _digest(manifest, adapter.arrays)
    buf = io.BytesIO()
    onp.savez(buf, **adapter.arrays)
    _write_atomic(os.path.join(path, 'params.npz'), buf.getvalue())
    _write_atomic(os.path.join(path, 'MANIFEST.json'),
                  (json.dumps(manifest, indent=1, sort_keys=True)
                   + '\n').encode())
    return path


def load_adapter(path):
    """Read an artifact directory and verify its digest: a byte changed
    anywhere in the manifest or the arrays raises ``ValueError`` (an
    archive the changed byte leaves unreadable too, where the reference
    raises zipfile's own error)."""
    with open(os.path.join(path, 'MANIFEST.json')) as f:
        manifest = json.load(f)
    if manifest.get('schema') != ADAPTER_SCHEMA:
        raise ValueError('not a %s artifact: %r at %s'
                         % (ADAPTER_SCHEMA, manifest.get('schema'), path))
    arrays = {}
    try:
        with onp.load(os.path.join(path, 'params.npz')) as z:
            for key in z.files:
                arrays[key] = z[key]
    except (zipfile.BadZipFile, EOFError) as exc:
        raise ValueError('adapter arrays unreadable at %s: %s (corrupt or '
                         'tampered artifact)' % (path, exc)) from exc
    want = manifest.get('digest')
    got = _digest(manifest, arrays)
    if want != got:
        raise ValueError('adapter digest mismatch at %s: manifest %s != '
                         'computed %s (corrupt or tampered artifact)'
                         % (path, want, got))
    return Adapter(manifest.get('name', 'adapter'), manifest['rank'],
                   manifest.get('scale', 1.0), arrays, got)


# -- pool geometry ---------------------------------------------------------------


class AdapterSpec:
    """What a decode program is built for: ``targets`` maps
    ``l{i}_{target}`` -> (out, in); each resident adapter takes one row of
    each target's ``(capacity, r, in)`` / ``(capacity, out, r)`` stack.
    Artifacts of a lower rank are zero-padded up: the rank is a ceiling."""

    def __init__(self, targets, rank, capacity):
        if capacity < 2:
            raise ValueError('adapter capacity %d < 2 (index 0 is the '
                             'reserved base entry)' % capacity)
        self.targets = {str(k): (int(o), int(i))
                        for k, (o, i) in dict(targets).items()}
        self.rank = int(rank)
        self.capacity = int(capacity)

    @classmethod
    def for_model(cls, model, rank, capacity):
        per = model.lora_targets()
        targets = {'l%d_%s' % (i, t): dims for i in range(model.layers)
                   for t, dims in per.items()}
        return cls(targets, rank, capacity)

    def device_tree(self, device):
        """All-zero pool tensors ``{target: (A, B)}`` on ``device``."""
        P, r = self.capacity, self.rank
        return {k: (torch.zeros((P, r, i), device=device),
                    torch.zeros((P, o, r), device=device))
                for k, (o, i) in self.targets.items()}

    def pool_bytes(self):
        P, r = self.capacity, self.rank
        return sum(4 * P * r * (o + i) for o, i in self.targets.values())

    def to_manifest(self):
        return {'targets': {k: list(v) for k, v in self.targets.items()},
                'rank': self.rank, 'capacity': self.capacity}

    @classmethod
    def from_manifest(cls, doc):
        return cls({k: tuple(v) for k, v in doc['targets'].items()},
                   doc['rank'], doc['capacity'])

    def __eq__(self, other):
        return isinstance(other, AdapterSpec) and (
            self.targets, self.rank, self.capacity) == (
                other.targets, other.rank, other.capacity)

    __hash__ = None


# -- the device-resident refcounted pool ----------------------------------------


class _Entry:
    __slots__ = ('digest', 'name', 'refs', 'last_used')

    def __init__(self, digest, name):
        self.digest = digest
        self.name = name
        self.refs = 0
        self.last_used = 0


class AdapterPool:
    """Refcounted device-resident adapter rows.

    :meth:`load` deduplicates by digest (a second tenant of the same
    fine-tune shares its row), claims a free row or evicts the least
    recently used unpinned one, and raises :class:`AdapterExhaustedError`
    when every row is pinned. The pool's tensors (:meth:`device_tree`) are
    made on ``device`` at first use, or are a decode program's own
    (:meth:`bind`): a load writes its row into them in place, on the
    current stream, after the programs already queued there."""

    def __init__(self, spec, device=None):
        self.spec = spec
        self.device = device
        self._lock = threading.Lock()
        self._entries = [None] * spec.capacity
        base = _Entry(None, 'base')
        base.refs = 1                      # never evictable
        self._entries[0] = base
        self._by_digest = {}               # digest -> index
        self._tick = 0
        self._device = None                # {target: (A, B)}
        self._loads = 0
        self._evictions = 0

    # -- device state ----------------------------------------------------

    def _ensure_device_locked(self):
        if self._device is None:
            self._device = self.spec.device_tree(resolve_device(self.device))
        return self._device

    def device_tree(self):
        """The pool tensors ``{target: (A (capacity, r, in), B (capacity,
        out, r))}`` the programs read."""
        with self._lock:
            return dict(self._ensure_device_locked())

    def bind(self, tree):
        """Make ``tree`` (a decode program's pool tensors, the spec's
        shapes) this pool's storage: the resident rows are copied in, the
        rest zeroed, and every later load writes there."""
        with self._lock:
            if self._device is tree:
                return
            for k, (o, i) in self.spec.targets.items():
                a, b = tree[k]
                P, r = self.spec.capacity, self.spec.rank
                if tuple(a.shape) != (P, r, i) or tuple(b.shape) != (P, o, r):
                    raise ValueError(
                        'adapter pool tensors of %s are %r / %r, the spec '
                        'asks for %r / %r' % (k, tuple(a.shape),
                                              tuple(b.shape), (P, r, i),
                                              (P, o, r)))
            with torch.no_grad():
                for k, (a, b) in tree.items():
                    if self._device is None:
                        a.zero_()
                        b.zero_()
                    else:
                        a.copy_(self._device[k][0])
                        b.copy_(self._device[k][1])
            self._device = tree
            self.device = next(iter(tree.values()))[0].device

    # -- load / release --------------------------------------------------

    def _padded(self, adapter):
        """Host arrays padded to the pool's rank, the scale folded into
        B."""
        if adapter.rank > self.spec.rank:
            raise ValueError('adapter %r rank %d exceeds pool rank %d'
                             % (adapter.name, adapter.rank, self.spec.rank))
        out = {}
        for key, (o, i) in self.spec.targets.items():
            a = adapter.arrays.get(key + '_a')
            b = adapter.arrays.get(key + '_b')
            if a is None or b is None:
                # a target this adapter leaves alone: zero rows keep it at
                # the frozen base
                a = onp.zeros((self.spec.rank, i), 'float32')
                b = onp.zeros((o, self.spec.rank), 'float32')
            else:
                pad = self.spec.rank - a.shape[0]
                a = onp.pad(onp.asarray(a, 'float32'), ((0, pad), (0, 0)))
                b = onp.pad(onp.asarray(b, 'float32') * adapter.scale,
                            ((0, 0), (0, pad)))
            out[key] = (a, b)
        return out

    def load(self, adapter):
        """Make ``adapter`` resident; returns its row with one reference
        taken."""
        padded = self._padded(adapter)
        with self._lock:
            self._tick += 1
            idx = self._by_digest.get(adapter.digest)
            if idx is not None:
                ent = self._entries[idx]
                ent.refs += 1
                ent.last_used = self._tick
                return idx
            ev0 = self._evictions
            idx = self._claim_row_locked()
            dev = self._ensure_device_locked()
            with torch.no_grad():
                for key, (a, b) in padded.items():
                    da, db = dev[key]
                    da[idx].copy_(torch.from_numpy(a))
                    db[idx].copy_(torch.from_numpy(b))
            ent = _Entry(adapter.digest, adapter.name)
            ent.refs = 1
            ent.last_used = self._tick
            self._entries[idx] = ent
            self._by_digest[adapter.digest] = idx
            self._loads += 1
            evicted = self._evictions - ev0
            resident = sum(1 for e in self._entries[1:] if e is not None)
        inst = _emit.serving()
        if evicted:
            if inst is not None:
                inst.adapter_evictions.inc()
            _emit.event('adapter_evict', index=idx)
        if inst is not None:
            inst.adapter_loads.inc()
            inst.active_adapters.set(float(resident))
        _emit.event('adapter_load', adapter=adapter.name, index=idx,
                    resident=resident)
        return idx

    def _claim_row_locked(self):
        for i in range(1, self.spec.capacity):
            if self._entries[i] is None:
                return i
        victim, oldest = None, None
        for i in range(1, self.spec.capacity):
            ent = self._entries[i]
            if ent.refs == 0 and (oldest is None or ent.last_used < oldest):
                victim, oldest = i, ent.last_used
        if victim is None:
            pinned = sum(1 for e in self._entries
                         if e is not None and e.refs > 0)
            raise AdapterExhaustedError(pinned, self.spec.capacity)
        old = self._entries[victim]
        del self._by_digest[old.digest]
        self._entries[victim] = None
        self._evictions += 1
        # the evicted row's A / B stay until overwritten, but no live
        # sequence indexes it
        return victim

    def acquire(self, index):
        """One more reference on a resident row."""
        with self._lock:
            self._tick += 1
            ent = self._entries[index]
            if ent is None:
                raise KeyError('adapter pool row %d is empty' % index)
            ent.refs += 1
            ent.last_used = self._tick
        return index

    def release(self, index):
        """Drop one reference; the row stays resident until an eviction
        needs it."""
        if index == 0:
            return
        with self._lock:
            ent = self._entries[index]
            if ent is not None and ent.refs > 0:
                ent.refs -= 1

    def index_of(self, digest):
        with self._lock:
            return self._by_digest.get(digest)

    def stats(self):
        with self._lock:
            resident = sum(1 for e in self._entries[1:] if e is not None)
            pinned = sum(1 for e in self._entries[1:]
                         if e is not None and e.refs > 0)
            return {'capacity': self.spec.capacity, 'resident': resident,
                    'pinned': pinned, 'loads': self._loads,
                    'evictions': self._evictions,
                    'pool_bytes': self.spec.pool_bytes()}


# -- id -> pool row ----------------------------------------------------------------


class AdapterRegistry:
    """Request adapter ids to pool rows: :meth:`register`-ed adapters
    first, then ``<root>/<id>`` artifact directories, loaded on first use
    (``MXNET_TPU_SERVE_ADAPTER_DIR``). ``None``, ``''`` and ``'base'`` are
    row 0, the frozen base, never refcounted."""

    BASE_IDS = (None, '', 'base')

    def __init__(self, pool, root=None):
        self.pool = pool
        self.root = root
        self._lock = threading.Lock()
        self._known = {}                 # id -> Adapter

    def register(self, adapter_id, adapter):
        with self._lock:
            self._known[str(adapter_id)] = adapter

    def ids(self):
        with self._lock:
            return sorted(self._known)

    def _resolve(self, adapter_id):
        with self._lock:
            ad = self._known.get(adapter_id)
        if ad is not None:
            return ad
        if self.root:
            path = os.path.join(self.root, adapter_id)
            if os.path.isdir(path):
                ad = load_adapter(path)
                with self._lock:
                    self._known.setdefault(adapter_id, ad)
                return ad
        raise KeyError('unknown adapter id %r (registered: %s%s)'
                       % (adapter_id, self.ids(),
                          '; root=%s' % self.root if self.root else ''))

    def acquire(self, adapter_id):
        """Admission: id -> referenced pool row (0 for the base). Raises
        ``KeyError`` for an unknown id and :class:`AdapterExhaustedError`
        when nothing can be evicted."""
        if adapter_id in self.BASE_IDS:
            return 0
        return self.pool.load(self._resolve(str(adapter_id)))

    def release(self, index):
        self.pool.release(index)

    def host_tree(self, adapter_id):
        """The host ``{target: (A, B)}`` delta of ``adapter_id`` (padded to
        the pool's rank, the scale folded), or None for the base."""
        if adapter_id in self.BASE_IDS:
            return None
        return self.pool._padded(self._resolve(str(adapter_id)))
