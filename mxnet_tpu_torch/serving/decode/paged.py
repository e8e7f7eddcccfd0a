"""Paged KV cache: one page pool per cache entry plus a page table per
sequence, the port of ``mxnet_tpu/serving/decode/paged.py``.

The slot cache reserves ``slots x max_len`` rows a layer whether a
sequence generates 4 tokens or 400. The paged layout holds **pages** of
``page_size`` rows instead:

  * the device holds one pool per cache entry, ``(pages, page_size,
    *row_shape)``;
  * each sequence owns a **page table**, an int32 ``(max_pages,)``
    vector of pool page indices, passed to the decode step as a plain
    tensor. The step's only cache operations are the row writes at
    ``(table[pos // page_size], pos % page_size)`` and the attention
    kernel reading each slot's rows through its table;
  * allocation, freeing, refcounts, prefix sharing and copy-on-write
    are decided on the host by the engine (:class:`PageAllocator`,
    :class:`PrefixCache`).

Page 0 is the reserved **trash page**: unused table entries point at it
and padded prefill rows land in it. A key past a slot's position gets
exactly 0.0 attention weight, so whatever the trash page holds never
changes a real sequence's sums: paged token streams are bitwise the slot
cache's.

**Prefix sharing**: a prompt's full pages are registered under a chain
key (parent key + the page's token tuple, an exact-match trie), its
partial tail page under the same scheme. A later prompt that walks the
same chain references those pages (refcount + 1) instead of prefilling
them. **Copy-on-write**: the first write into a page whose refcount is
above 1 copies it to a fresh page (:func:`copy_page`) and repoints only
that sequence's table.

The JAX package updates the pool functionally; the port's pool ops write
the pool tensors **in place** (indexed assignment), as ``cache.py`` does
for the slot cache, and return the tensor they wrote.
"""
from __future__ import annotations

import numpy as onp
import torch

__all__ = ['PagedCacheSpec', 'PageAllocator', 'PrefixCache', 'TRASH_PAGE',
           'init_pool', 'pool_bytes', 'gather_pages', 'write_paged_rows',
           'write_paged_chunk', 'write_prefill_pages', 'copy_page',
           'pages_for']

# pool page 0 is never allocated: unused page-table entries and padded
# prefill rows point at it, and reads of it are masked to weight 0
TRASH_PAGE = 0


def pages_for(n_tokens, page_size):
    """Pages needed to hold ``n_tokens`` KV rows (ceil)."""
    return -(-int(n_tokens) // int(page_size))


class PagedCacheSpec:
    """Metadata for one paged cache: ``{name: (row_shape, dtype)}``; the
    pool of ``pages`` pages of ``page_size`` rows is ``(pages,
    page_size) + row_shape``. ``max_pages``, the page-table length, is
    ``ceil(max_len / page_size)``."""

    __slots__ = ('entries', 'page_size', 'max_pages')

    def __init__(self, entries, page_size, max_len):
        self.page_size = int(page_size)
        if self.page_size < 1 or (self.page_size & (self.page_size - 1)):
            raise ValueError('page_size must be a positive power of two, '
                             'got %d' % self.page_size)
        self.max_pages = pages_for(int(max_len), self.page_size)
        self.entries = {str(k): (tuple(int(d) for d in shape), str(dt))
                        for k, (shape, dt) in dict(entries).items()}

    def items(self):
        return self.entries.items()

    def full_shape(self, name, pages):
        shape, _ = self.entries[name]
        return (int(pages), self.page_size) + shape

    def to_json(self):
        return {'page_size': self.page_size,
                'max_pages': self.max_pages,
                'entries': {k: [list(s), dt]
                            for k, (s, dt) in self.entries.items()}}

    @classmethod
    def from_json(cls, obj):
        entries = {k: (tuple(s), dt)
                   for k, (s, dt) in obj['entries'].items()}
        return cls(entries, obj['page_size'],
                   obj['max_pages'] * obj['page_size'])

    def __repr__(self):
        return ('PagedCacheSpec(page_size=%d, max_pages=%d, %r)'
                % (self.page_size, self.max_pages, self.entries))


def pool_bytes(spec, pages):
    """Device bytes of a pool of ``pages`` pages: the paged cache's real
    residency."""
    total = 0
    for _name, (shape, dt) in spec.items():
        n = int(pages) * spec.page_size
        for d in shape:
            n *= d
        total += n * onp.dtype(dt).itemsize
    return total


def init_pool(spec, pages, device):
    """Zero-filled pool ``{name: (pages, page_size, *row_shape)}`` on
    ``device``: zeros, so that stale rows stay finite under the mask
    (``cache.init_cache``'s argument)."""
    return {name: torch.zeros(spec.full_shape(name, pages),
                              dtype=getattr(torch, dt), device=device)
            for name, (_, dt) in spec.items()}


# -- pool ops on the device (in place) ----------------------------------------


def gather_pages(pool_arr, tables):
    """Each slot's rows through its page table: ``pool_arr`` (pages,
    page_size, *row), ``tables`` (slots, max_pages) int -> a new (slots,
    max_pages * page_size, *row) tensor. The plain version's view; the
    decode kernel reads the rows in place instead."""
    g = pool_arr[tables.long()]                  # (S, P, ps, *row)
    s, p, ps = g.shape[:3]
    return g.reshape((s, p * ps) + tuple(g.shape[3:]))


def write_paged_rows(pool_arr, rows, page_ids, offsets):
    """The decode-step append: ``rows[s]`` at ``(page_ids[s],
    offsets[s])`` for every slot, in place; ``page_ids`` / ``offsets``
    (slots,) int64 on the pool's device. Live slots never share a
    writable row; free slots all write ``(TRASH_PAGE, 0)``, where the
    last writer wins and is masked. Returns ``pool_arr``."""
    pool_arr[page_ids, offsets] = rows.to(pool_arr.dtype)
    return pool_arr


def write_paged_chunk(pool_arr, rows, page_ids, offsets):
    """The multi-token append of the speculative verify: ``rows``
    (slots, C, *row) at ``page_ids`` / ``offsets`` (slots, C), in place.
    Returns ``pool_arr``."""
    s, c = rows.shape[:2]
    pool_arr[page_ids.reshape(-1), offsets.reshape(-1)] = \
        rows.reshape((s * c,) + tuple(rows.shape[2:])).to(pool_arr.dtype)
    return pool_arr


def write_prefill_pages(pool_arr, rows, page_ids):
    """The prefill landing: ``rows`` (npages * page_size, *row), the
    prompt's K or V padded to whole pages, written page by page to the
    host-allocated ``page_ids`` (npages,) int64, in place; trailing
    all-padding pages point at the trash page. Returns ``pool_arr``."""
    npages = page_ids.shape[0]
    pool_arr[page_ids] = rows.reshape(
        (npages, pool_arr.shape[1]) + tuple(rows.shape[1:])).to(
            pool_arr.dtype)
    return pool_arr


def copy_page(pool_arr, src, dst):
    """Copy page ``src`` over page ``dst`` in place (the copy-on-write
    primitive, O(page)); each an int or a one-element integer tensor on
    the pool's device (no host read). Returns ``pool_arr``."""
    src, dst = (torch.as_tensor(i, dtype=torch.int64,
                                device=pool_arr.device).reshape(1)
                for i in (src, dst))
    pool_arr.index_copy_(0, dst, pool_arr.index_select(0, src))
    return pool_arr


# -- host-side allocation (the engine's scheduler state) ----------------------


class PageAllocator:
    """Free list + refcounts over the pool's page indices.

    Page ``TRASH_PAGE`` (0) is reserved. An allocated page starts at
    refcount 1 (the allocating sequence's hold); the prefix registry and
    later sharers take more holds through :meth:`ref`; :meth:`release`
    drops one and frees the page at zero. No locks: the engine calls it
    under its own scheduler lock."""

    def __init__(self, pages):
        self.pages = int(pages)
        if self.pages < 2:
            raise ValueError('pool needs >= 2 pages (page 0 is the '
                             'reserved trash page), got %d' % self.pages)
        self.reset()

    def reset(self):
        """Forget everything (the engine rebuilt the device pool)."""
        # LIFO free list: O(1) a page, and recently freed pages recycle
        # first
        self._free = list(range(self.pages - 1, 0, -1))
        self._ref = {}

    @property
    def free_pages(self):
        return len(self._free)

    @property
    def used_pages(self):
        return self.pages - 1 - len(self._free)

    def occupancy_pct(self):
        usable = self.pages - 1
        return 100.0 * self.used_pages / usable if usable else 0.0

    def can_alloc(self, n):
        return len(self._free) >= int(n)

    def alloc(self, n):
        """``n`` fresh pages at refcount 1, or None when the pool cannot
        give them all (never a partial grant)."""
        n = int(n)
        if len(self._free) < n:
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def ref(self, page):
        """Take one more hold on an allocated page."""
        if page == TRASH_PAGE:
            return page
        if page not in self._ref:
            raise ValueError('ref of unallocated page %d' % page)
        self._ref[page] += 1
        return page

    def refcount(self, page):
        return self._ref.get(page, 0)

    def release(self, page):
        """Drop one hold; at zero the page returns to the free list."""
        if page == TRASH_PAGE:
            return
        cnt = self._ref.get(page)
        if cnt is None:
            raise ValueError('release of unallocated page %d' % page)
        if cnt <= 1:
            del self._ref[page]
            self._free.append(page)
        else:
            self._ref[page] = cnt - 1

    def stats(self):
        return {'pages_total': self.pages - 1,
                'pages_free': self.free_pages,
                'pages_used': self.used_pages,
                'occupancy_pct': round(self.occupancy_pct(), 2)}


class _PrefixNode:
    __slots__ = ('page', 'tokens', 'parent', 'children', 'last_used')

    def __init__(self, page, tokens, parent, now):
        self.page = page
        self.tokens = tokens
        self.parent = parent          # parent key or None
        self.children = 0
        self.last_used = now


class PrefixCache:
    """Exact-match trie of prompt pages -> pool page indices.

    Keys are ``(parent_key, tokens_tuple)``: the chain is the key, so two
    prefixes never collide. Full pages chain with ``len(tokens) ==
    page_size``; a prompt's partial tail page registers with its shorter
    tuple and is shared only on an exact match of the remaining tokens.

    Each registered node holds one allocator ref on its page, so a
    retired owner's pages stay for later hits until :meth:`evict_lru`
    reclaims them under pool pressure (leaves first, least recently used
    first: a parent page is never freed while a child chains through
    it). A ``namespace`` (the engine passes the adapter id) roots a
    disjoint trie: one adapter's K/V rows for the same tokens differ from
    another's and the base's, so a hit never crosses namespaces."""

    def __init__(self, page_size, allocator):
        self.page_size = int(page_size)
        self._alloc = allocator
        self._nodes = {}
        self._by_page = {}      # page id -> node key
        self._seq = 0
        self.evictions = 0

    def __len__(self):
        return len(self._nodes)

    def clear(self):
        """Drop every registration without releasing pages (the
        allocator itself was reset)."""
        self._nodes = {}
        self._by_page = {}

    def _tick(self):
        self._seq += 1
        return self._seq

    def _chunks(self, prompt):
        ps = self.page_size
        full = len(prompt) // ps
        out = [tuple(prompt[i * ps:(i + 1) * ps]) for i in range(full)]
        return out, tuple(prompt[full * ps:])

    @staticmethod
    def _root(namespace):
        """The root parent key of ``namespace``: None keeps the keys of
        the base; anything else roots a trie of its own."""
        return None if namespace is None else ('ns', str(namespace))

    def register(self, prompt, page_ids, namespace=None):
        """Record ``prompt``'s pages (full chain + partial tail) in
        ``namespace`` for later sharers, one allocator ref on each newly
        registered page. ``page_ids[i]`` holds prompt positions ``[i * ps,
        (i + 1) * ps)``."""
        now = self._tick()
        chunks, tail = self._chunks(prompt)
        parent = self._root(namespace)
        for i, chunk in enumerate(chunks + ([tail] if tail else [])):
            key = (parent, chunk)
            node = self._nodes.get(key)
            if node is None:
                page = page_ids[i]
                if page == TRASH_PAGE:
                    break               # the prompt outran its pages
                self._alloc.ref(page)
                node = _PrefixNode(page, chunk, parent, now)
                self._nodes[key] = node
                self._by_page[page] = key
                if parent is not None and parent in self._nodes:
                    self._nodes[parent].children += 1
            node.last_used = now
            parent = key

    def lookup(self, prompt, namespace=None):
        """The longest registered chain in ``namespace`` covering
        ``prompt``'s head: ``(page_ids, tokens_covered)``, without taking
        refs (the engine refs the pages it uses). Full pages chain first;
        a partial tail matches only the remaining tokens exactly."""
        now = self._tick()
        chunks, tail = self._chunks(prompt)
        pages = []
        parent = self._root(namespace)
        covered = 0
        for chunk in chunks:
            node = self._nodes.get((parent, chunk))
            if node is None:
                break
            node.last_used = now
            pages.append(node.page)
            covered += len(chunk)
            parent = (parent, chunk)
        else:
            if tail:
                node = self._nodes.get((parent, tail))
                if node is not None:
                    node.last_used = now
                    pages.append(node.page)
                    covered += len(tail)
        return pages, covered

    def release_leaf(self, page):
        """Drop the leaf registration holding ``page``: the
        copy-on-write shortcut when the registry is a page's only other
        holder (refcount 2), so that the owner's write is private without
        a copy. Only leaves go (a mid-chain page keeps its descendants'
        chains whole). Returns True when a registration was dropped."""
        key = self._by_page.get(page)
        if key is None:
            return False
        node = self._nodes.get(key)
        if node is None or node.page != page or node.children:
            return False
        del self._nodes[key]
        del self._by_page[page]
        if node.parent is not None and node.parent in self._nodes:
            self._nodes[node.parent].children -= 1
        self._alloc.release(page)
        return True

    def evict_lru(self, want_pages=1):
        """Drop least recently used leaf registrations until
        ``want_pages`` pages could be allocated (or nothing is left to
        evict). Returns the page ids freed."""
        freed = []
        while not self._alloc.can_alloc(want_pages):
            leaves = [(node.last_used, key)
                      for key, node in self._nodes.items()
                      if node.children == 0]
            if not leaves:
                break
            _, key = min(leaves)
            node = self._nodes.pop(key)
            self._by_page.pop(node.page, None)
            if node.parent is not None and node.parent in self._nodes:
                self._nodes[node.parent].children -= 1
            before = self._alloc.free_pages
            self._alloc.release(node.page)
            if self._alloc.free_pages > before:
                freed.append(node.page)
            self.evictions += 1
        return freed
