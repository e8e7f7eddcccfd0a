"""The decode families served by the decode engine, the port of
``mxnet_tpu/serving/decode/model.py``: the causal transformer LM
(``TransformerLM``) and the RNN language model (``RNNLM``).

One math path serves prefill, the decode step and the uncached
reference forward, so that N tokens decoded through the cache equal the
N tokens of re-running the whole-sequence forward after every token.
Attention always goes through ``ops/kernels/attention.py``: the
flash-prefill kernel in :meth:`TransformerLM.prefill`,
:meth:`TransformerLM.paged_prefill` and :meth:`TransformerLM.full_forward`,
the flash-decode kernel in :meth:`TransformerLM.step` and its paged
instance in :meth:`TransformerLM.paged_step` (their plain PyTorch versions
on the CPU). The speculative :meth:`TransformerLM.paged_verify` is plain
attention, as in the JAX package.

Parameters are a ``{name: tensor}`` dict under the JAX model's names and
``(out, in)`` weight layout, so :func:`params_from_jax` carries a JAX
model's weights over without transposes. The JAX expressions that set
rounding are kept: layer norm as mean / var / sqrt(var + eps), exact-erf
GELU, the tied head ``x @ embed.T + out_bias``, and ``q * scale`` inside
the attention function, as the kernels do. Every path takes an optional
``ad``, the low-rank adapter deltas of its rows (``lora_targets``: the
fused QKV and the two FFN projections); the deltas are plain
``torch.einsum`` products, as the JAX package leaves them to XLA.

:class:`RNNLM` is Embedding -> the fused multi-layer cell of
``ops/nn.py`` (lstm, gru, rnn_relu, rnn_tanh) -> Dense. Its recurrent
state is its cache: a ``(layers, hidden)`` ``h`` (and ``c`` for an LSTM)
a slot, O(1) a token. The prefill scans every step of its bucket and
freezes the state at ``t >= length`` on the device, as the reference's
``t < length`` select does, so no host branch breaks a captured program;
the step ignores positions. No kernel is on this path: the JAX model runs
its cells with XLA, and the port with plain products and pointwise ops.
It takes no adapter and serves the slot cache only.
"""
from __future__ import annotations

import numpy as onp
import torch
import torch.nn.functional as F

from ...context import resolve_device
from ...ops.nn import _cell_step, _rnn_unpack_params, rnn_param_size
from ...ops.kernels.attention import (flash_attention, flash_decode_attention,
                                      flash_paged_decode_attention)
from .cache import CacheSpec, write_position, write_slot
from .paged import (PagedCacheSpec, gather_pages, write_paged_chunk,
                    write_paged_rows, write_prefill_pages)

__all__ = ['DecodeModel', 'RNNLM', 'TransformerLM', 'from_gluon_rnn_lm',
           'init_rnn_lm', 'init_transformer_lm', 'model_from_config',
           'params_from_jax']

_LAYER_PARAMS = ('qkv_w', 'qkv_b', 'out_w', 'out_b', 'ln1_g', 'ln1_b',
                 'ffn1_w', 'ffn1_b', 'ffn2_w', 'ffn2_b', 'ln2_g', 'ln2_b')


class DecodeModel:
    """Interface of a decode family (pure functions over a ``{name:
    tensor}`` params dict; the cache is updated in place):

      * ``cache_spec()``                         -> :class:`CacheSpec`
      * ``prefill(params, cache, tokens, length, slot)``
          tokens (1, S) int64 -> (cache, logits (V,)) at position length-1
      * ``step(params, cache, tokens, positions)``
          tokens (slots,) int64, positions (slots,) int32
          -> (cache, logits (slots, V))
      * ``full_forward(params, tokens)``
          tokens (B, T) int64 -> logits (B, T, V), the uncached reference

    A family with ``supports_paging`` also serves the paged cache
    (``paged_spec``, ``paged_prefill``, ``paged_step``, ``paged_verify``).
    """

    family = None
    supports_paging = False

    def __init__(self, config):
        self.config = dict(config)
        self.vocab = int(config['vocab'])
        self.max_len = int(config['max_len'])

    def __repr__(self):
        return '%s(%r)' % (type(self).__name__, self.config)

    def check_params(self, params):
        """Raise ValueError unless ``params`` holds exactly this model's
        names at their shapes (``param_shapes()``)."""
        self.check_shapes({k: tuple(v.shape) for k, v in params.items()})

    def check_shapes(self, shapes):
        """:meth:`check_params` over a ``{name: shape}`` dict."""
        want = self.param_shapes()
        missing = sorted(set(want) - set(shapes))
        extra = sorted(set(shapes) - set(want))
        if missing or extra:
            raise ValueError('params do not match %r: missing %s, '
                             'unexpected %s' % (self, missing, extra))
        for name, shape in want.items():
            if tuple(shapes[name]) != shape:
                raise ValueError('param %s has shape %r, expected %r'
                                 % (name, tuple(shapes[name]), shape))


class RNNLM(DecodeModel):
    """Embedding -> multi-layer {lstm, gru, rnn_relu, rnn_tanh} -> Dense.

    config: vocab, embed, hidden, layers, mode, max_len.
    params: embed_weight (V, E), rnn_params (the flat cuDNN layout the
    fused op and the gluon layers' ``_flat_params`` use), out_weight (V,
    H), out_bias (V,).
    """

    family = 'rnn_lm'

    def __init__(self, config):
        super().__init__(config)
        self.mode = str(config['mode'])
        if self.mode not in ('lstm', 'gru', 'rnn_relu', 'rnn_tanh'):
            raise ValueError('unsupported RNN mode %r' % self.mode)
        self.embed = int(config['embed'])
        self.hidden = int(config['hidden'])
        self.layers = int(config['layers'])

    def cache_spec(self):
        """The state a slot carries: ``h`` (and ``c``), (layers, hidden)
        each."""
        entries = {'h': ((self.layers, self.hidden), 'float32')}
        if self.mode == 'lstm':
            entries['c'] = ((self.layers, self.hidden), 'float32')
        return CacheSpec(entries)

    def param_shapes(self):
        """``{name: shape}`` of every parameter."""
        n = rnn_param_size(self.mode, self.layers, self.embed, self.hidden,
                           False)
        return {'embed_weight': (self.vocab, self.embed),
                'rnn_params': (n,),
                'out_weight': (self.vocab, self.hidden),
                'out_bias': (self.vocab,)}

    def init_params(self, seed=0):
        """Random float32 weights from ``seed`` as a ``{name: ndarray}``
        dict, the JAX model's draws in its order (0.1 N(0, 1), a zero
        head bias)."""
        rs = onp.random.RandomState(seed)
        n = self.param_shapes()['rnn_params'][0]
        return {
            'embed_weight': rs.randn(self.vocab, self.embed)
            .astype('float32') * 0.1,
            'rnn_params': rs.randn(n).astype('float32') * 0.1,
            'out_weight': rs.randn(self.vocab, self.hidden)
            .astype('float32') * 0.1,
            'out_bias': onp.zeros(self.vocab, 'float32'),
        }

    def _unpacked(self, params):
        """Each layer's ((W_i2h, W_h2h), (b_i2h, b_h2h)) of the flat
        vector: views, no copy."""
        return _rnn_unpack_params(params['rnn_params'], self.mode,
                                  self.layers, self.embed, self.hidden,
                                  False)

    def _scan_layers(self, params, x, h0, c0, length=None):
        """The sequence pass: x (T, B, E) -> (ys (T, B, H), hT, cT), h0 /
        c0 (layers, B, H). ``length`` (an int, or a one-element int
        tensor on the device) freezes the state at t >= length and zeroes
        those outputs, on the device; None runs every step."""
        Ws, Bs = self._unpacked(params)
        T = x.shape[0]
        keep = None if length is None else \
            torch.arange(T, device=x.device) < torch.as_tensor(
                length, device=x.device).reshape(())
        hs, cs = [], []
        for layer in range(self.layers):
            (w_i2h, w_h2h), (b_i2h, b_h2h) = Ws[layer][0], Bs[layer][0]
            # the input projection of the whole sequence as one product
            xw = torch.matmul(x, w_i2h.t()) + b_i2h
            carry = (h0[layer], c0[layer]) if self.mode == 'lstm' \
                else (h0[layer],)
            ys = []
            for t in range(T):
                new, y = _cell_step(self.mode, carry, xw[t], w_h2h, b_h2h)
                if keep is not None:
                    new = tuple(torch.where(keep[t], n, o)
                                for n, o in zip(new, carry))
                    y = torch.where(keep[t], y, torch.zeros_like(y))
                carry = new
                ys.append(y)
            hs.append(carry[0])
            if self.mode == 'lstm':
                cs.append(carry[1])
            x = torch.stack(ys, dim=0)
        return x, torch.stack(hs, dim=0), \
            torch.stack(cs, dim=0) if cs else None

    def _head(self, params, h):
        return torch.matmul(h, params['out_weight'].t()) + params['out_bias']

    def prefill(self, params, cache, tokens, length, slot):
        """Scan the padded prompt ``tokens`` (1, S), frozen past
        ``length``, land the state in ``slot`` (in place) and return
        (cache, logits (V,)) at position ``length - 1``: the head of the
        top layer's final h. ``length`` and ``slot``: ints or one-element
        int tensors on the device."""
        x = F.embedding(tokens[0], params['embed_weight'])[:, None]
        zeros = torch.zeros((self.layers, 1, self.hidden),
                            dtype=torch.float32, device=tokens.device)
        _, hT, cT = self._scan_layers(params, x, zeros, zeros, length)
        write_slot(cache['h'], hT[:, 0], slot)
        if cT is not None:
            write_slot(cache['c'], cT[:, 0], slot)
        return cache, self._head(params, hT[-1, 0])

    def step(self, params, cache, tokens, positions):
        """Advance every slot one token (positions are not read: the
        state is positionless); the new state is written in place.
        Returns (cache, logits (slots, V))."""
        del positions
        Ws, Bs = self._unpacked(params)
        x = F.embedding(tokens, params['embed_weight'])   # (slots, E)
        h, c = cache['h'], cache.get('c')                 # (slots, L, H)
        new_h, new_c = [], []
        for layer in range(self.layers):
            (w_i2h, w_h2h), (b_i2h, b_h2h) = Ws[layer][0], Bs[layer][0]
            xw = torch.matmul(x, w_i2h.t()) + b_i2h
            carry = (h[:, layer], c[:, layer]) if self.mode == 'lstm' \
                else (h[:, layer],)
            carry, x = _cell_step(self.mode, carry, xw, w_h2h, b_h2h)
            new_h.append(carry[0])
            if self.mode == 'lstm':
                new_c.append(carry[1])
        h.copy_(torch.stack(new_h, dim=1))
        if new_c:
            c.copy_(torch.stack(new_c, dim=1))
        return cache, self._head(params, x)

    def full_forward(self, params, tokens):
        """Uncached reference: tokens (B, T) -> logits (B, T, V)."""
        B = tokens.shape[0]
        x = F.embedding(tokens, params['embed_weight']).transpose(0, 1)
        zeros = torch.zeros((self.layers, B, self.hidden),
                            dtype=torch.float32, device=tokens.device)
        ys, _, _ = self._scan_layers(params, x, zeros, zeros)
        return self._head(params, ys).transpose(0, 1)


class TransformerLM(DecodeModel):
    """Causal decoder over bert.py-style blocks (fused QKV, post-norm
    residual cells, GELU FFN, tied embedding head) with a preallocated
    per-slot KV cache, or a paged one (``paged_*``).

    config: vocab, units, hidden, layers, heads, max_len, eps.
    params: embed (V, U), pos (max_len, U), out_bias (V,), and per layer
    ``l{i}_``: qkv_w (3U, U), qkv_b, out_w (U, U), out_b, ln1_g/ln1_b,
    ffn1_w (H, U), ffn1_b, ffn2_w (U, H), ffn2_b, ln2_g/ln2_b.
    """

    family = 'transformer_lm'

    def __init__(self, config):
        config = dict(config)
        config.setdefault('eps', 1e-12)
        super().__init__(config)
        self.units = int(config['units'])
        self.hidden = int(config['hidden'])
        self.layers = int(config['layers'])
        self.heads = int(config['heads'])
        self.eps = float(config['eps'])
        if self.units % self.heads:
            raise ValueError('units %d not divisible by heads %d'
                             % (self.units, self.heads))
        self.scale = 1.0 / float(onp.sqrt(self.units // self.heads))

    def cache_spec(self):
        return CacheSpec({
            'l%d_%s' % (i, kv): ((self.max_len, self.units), 'float32')
            for i in range(self.layers) for kv in ('k', 'v')})

    def param_shapes(self):
        """``{name: shape}`` of every parameter."""
        U, H = self.units, self.hidden
        shapes = {'embed': (self.vocab, U), 'pos': (self.max_len, U),
                  'out_bias': (self.vocab,)}
        per = {'qkv_w': (3 * U, U), 'qkv_b': (3 * U,), 'out_w': (U, U),
               'out_b': (U,), 'ln1_g': (U,), 'ln1_b': (U,),
               'ffn1_w': (H, U), 'ffn1_b': (H,), 'ffn2_w': (U, H),
               'ffn2_b': (U,), 'ln2_g': (U,), 'ln2_b': (U,)}
        for i in range(self.layers):
            for n in _LAYER_PARAMS:
                shapes['l%d_%s' % (i, n)] = per[n]
        return shapes

    def init_params(self, seed=0):
        """Random float32 weights from ``seed`` as a ``{name: ndarray}``
        dict -- the same draws, in the same order, as the JAX model's
        ``init_params``."""
        rs = onp.random.RandomState(seed)
        U, H = self.units, self.hidden

        def w(*shape):
            return (rs.randn(*shape) * 0.05).astype('float32')

        params = {'embed': w(self.vocab, U),
                  'pos': w(self.max_len, U),
                  'out_bias': onp.zeros(self.vocab, 'float32')}
        for i in range(self.layers):
            params.update({
                'l%d_qkv_w' % i: w(3 * U, U),
                'l%d_qkv_b' % i: onp.zeros(3 * U, 'float32'),
                'l%d_out_w' % i: w(U, U),
                'l%d_out_b' % i: onp.zeros(U, 'float32'),
                'l%d_ln1_g' % i: onp.ones(U, 'float32'),
                'l%d_ln1_b' % i: onp.zeros(U, 'float32'),
                'l%d_ffn1_w' % i: w(H, U),
                'l%d_ffn1_b' % i: onp.zeros(H, 'float32'),
                'l%d_ffn2_w' % i: w(U, H),
                'l%d_ffn2_b' % i: onp.zeros(U, 'float32'),
                'l%d_ln2_g' % i: onp.ones(U, 'float32'),
                'l%d_ln2_b' % i: onp.zeros(U, 'float32'),
            })
        return params

    # -- low-rank adapters (serving/adapters/) -------------------------------

    def lora_targets(self):
        """The projections an adapter may delta, with their (out, in):
        the shapes ``serving.adapters`` sizes its pool rows to. Per-layer
        names follow the params (``l{i}_qkv`` and so on)."""
        U, H = self.units, self.hidden
        return {'qkv': (3 * U, U), 'ffn1': (H, U), 'ffn2': (U, H)}

    @staticmethod
    def _lora_delta(x, a, b):
        """The low-rank delta ``(x @ A^T) @ B^T`` (the scale is in B).
        ``a`` / ``b`` 2-D is one adapter for the whole call (prefill: a (r,
        in), b (out, r)); 3-D is one a slot (a (s, r, in), b (s, out, r))
        applied to x (s, ..., in). Row 0 of the pool is zero, so the base
        delta is 0.0 everywhere."""
        if a.dim() == 2:
            return torch.einsum('...r,or->...o',
                                torch.einsum('...i,ri->...r', x, a), b)
        h = torch.einsum('s...i,sri->s...r', x, a)
        return torch.einsum('s...r,sor->s...o', h, b)

    def _adapted(self, x, w, b, ad, key):
        """The dense projection plus the adapter delta of ``ad`` (maps
        ``l{i}_{target}`` -> (A, B) already selected for this call's
        rows). With ``ad`` None the body is the plain projection, not the
        same plus a zero."""
        y = self._dense(x, w, b)
        if ad is not None and key in ad:
            la, lb = ad[key]
            y = y + self._lora_delta(x, la, lb)
        return y

    # -- shared block math --------------------------------------------------

    def _ln(self, x, g, b):
        mu = x.mean(dim=-1, keepdim=True)
        var = torch.square(x - mu).mean(dim=-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + self.eps) * g + b

    @staticmethod
    def _dense(x, w, b):
        return torch.matmul(x, w.t()) + b

    def _embed(self, params, tokens, positions):
        return F.embedding(tokens, params['embed']) \
            + F.embedding(positions, params['pos'])

    def _attn_out_ffn(self, params, i, x, ctx, ad=None):
        """Output projection + post-norm residual, then the FFN cell
        (its two projections adapted by ``ad``)."""
        p = lambda n: params['l%d_%s' % (i, n)]           # noqa: E731
        x = self._ln(x + self._dense(ctx, p('out_w'), p('out_b')),
                     p('ln1_g'), p('ln1_b'))
        h = F.gelu(self._adapted(x, p('ffn1_w'), p('ffn1_b'), ad,
                                 'l%d_ffn1' % i), approximate='none')
        return self._ln(x + self._adapted(h, p('ffn2_w'), p('ffn2_b'), ad,
                                          'l%d_ffn2' % i),
                        p('ln2_g'), p('ln2_b'))

    def _qkv(self, params, i, x, ad):
        return self._adapted(x, params['l%d_qkv_w' % i],
                             params['l%d_qkv_b' % i], ad, 'l%d_qkv' % i) \
            .split(self.units, dim=-1)

    def _head(self, params, h):
        return torch.matmul(h, params['embed'].t()) + params['out_bias']

    def _heads(self, x):
        # (B, S, U) -> (B, H, S, D), contiguous for the kernel
        b, s, _ = x.shape
        return x.reshape(b, s, self.heads, self.units // self.heads) \
            .permute(0, 2, 1, 3).contiguous()

    def _full_pass(self, params, tokens, lengths, ad=None):
        """Whole-sequence causal pass: tokens (B, S) -> (hidden (B, S,
        U), per-layer (k, v) each (B, S, U)). ``lengths`` (B,) int32
        masks padded keys; ``ad`` adapts the projections (2-D: one
        adapter; 3-D: one a batch row); the prefill AND reference
        path."""
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)
        x = self._embed(params, tokens, positions[None, :])
        kvs = []
        for i in range(self.layers):
            q, k, v = self._qkv(params, i, x, ad)
            kvs.append((k, v))
            ctx = flash_attention(self._heads(q), self._heads(k),
                                  self._heads(v), lengths=lengths,
                                  causal=True, scale=self.scale)
            ctx = ctx.permute(0, 2, 1, 3).reshape(B, S, self.units)
            x = self._attn_out_ffn(params, i, x, ctx, ad)
        return x, kvs

    @staticmethod
    def _lengths(length, device):
        """``length`` (an int, or a one-element int tensor on ``device``,
        as a captured program passes it) as a (1,) int32 tensor."""
        return torch.as_tensor(length, dtype=torch.int32,
                               device=device).reshape(1)

    def _last(self, params, x, lengths):
        """The head's logits (V,) at position ``lengths[0] - 1`` of
        ``x`` (1, S, U), selected on the device."""
        return self._head(params, x[0].index_select(0, lengths.long() - 1)[0])

    def prefill(self, params, cache, tokens, length, slot, ad=None):
        """Run the padded prompt ``tokens`` (1, S), land its KV prefix
        in ``slot`` (in place, tail zeroed) and return (cache, logits
        (V,)) at position ``length - 1``. ``length`` and ``slot`` are
        ints or one-element int tensors on the device (no host read);
        ``ad`` is one adapter's 2-D (A, B) a target, or None."""
        lengths = self._lengths(length, tokens.device)
        x, kvs = self._full_pass(params, tokens, lengths, ad)
        for i, (k, v) in enumerate(kvs):
            write_slot(cache['l%d_k' % i], k[0], slot)
            write_slot(cache['l%d_v' % i], v[0], slot)
        return cache, self._last(params, x, lengths)

    def step(self, params, cache, tokens, positions, ad=None):
        """Advance every slot one token: append each slot's K/V row at
        its own position (in place) and attend its own prefix. ``ad`` is
        a 3-D (A, B) stack a target, one adapter a slot, or None. Returns
        (cache, logits (slots, V))."""
        pos_idx = positions.long()
        x = self._embed(params, tokens, pos_idx)          # (slots, U)
        for i in range(self.layers):
            q, k, v = self._qkv(params, i, x, ad)
            ck = write_position(cache['l%d_k' % i], k, pos_idx)
            cv = write_position(cache['l%d_v' % i], v, pos_idx)
            ctx = flash_decode_attention(q.contiguous(), ck, cv, positions,
                                         heads=self.heads, scale=self.scale)
            x = self._attn_out_ffn(params, i, x, ctx, ad)
        return cache, self._head(params, x)

    def full_forward(self, params, tokens, ad=None):
        """Uncached reference: tokens (B, T) -> logits (B, T, V), adapted
        by ``ad`` (2-D: one adapter; 3-D: one a batch row) when given."""
        B, T = tokens.shape
        lengths = torch.full((B,), T, dtype=torch.int32,
                             device=tokens.device)
        x, _ = self._full_pass(params, tokens, lengths, ad)
        return self._head(params, x)

    # -- the paged cache ----------------------------------------------------

    supports_paging = True

    def paged_spec(self, page_size):
        """Pool metadata: one (pages, page_size, units) pool per layer's
        K and V."""
        return PagedCacheSpec(
            {'l%d_%s' % (i, kv): ((self.units,), 'float32')
             for i in range(self.layers) for kv in ('k', 'v')},
            page_size, self.max_len)

    def paged_prefill(self, params, pool, tokens, length, page_ids, ad=None):
        """The prefill through the page table: the same ``_full_pass`` as
        :meth:`prefill` (so the same logits), with the prompt's K/V,
        zero-padded to whole pages, written page by page to the
        host-allocated ``page_ids`` (npages,) int64 in place; trailing
        all-padding pages point at the trash page. Returns (pool, logits
        (V,)) at position ``length - 1`` (``length`` and ``ad``: as
        :meth:`prefill` takes them)."""
        lengths = self._lengths(length, tokens.device)
        x, kvs = self._full_pass(params, tokens, lengths, ad)
        rows = page_ids.shape[0] * next(iter(pool.values())).shape[1]
        pad = rows - tokens.shape[1]
        for i, (k, v) in enumerate(kvs):
            for name, arr in (('k', k), ('v', v)):
                write_prefill_pages(pool['l%d_%s' % (i, name)],
                                    F.pad(arr[0], (0, 0, 0, pad)), page_ids)
        return pool, self._last(params, x, lengths)

    def paged_step(self, params, pool, tokens, positions, tables, ad=None):
        """One decode step over the pool: :meth:`step`'s math, with each
        slot's row written at ``(table[pos // ps], pos % ps)`` (in place)
        and the paged decode kernel reading its keys through its table
        (``tables`` (slots, max_pages) int32). Keys past a slot's position,
        trash-page rows among them, get weight 0, so the logits are
        bitwise :meth:`step`'s over the same K/V (``ad``: as :meth:`step`
        takes it). Returns (pool, logits (slots, V))."""
        ps = next(iter(pool.values())).shape[1]
        pos_idx = positions.long()
        x = self._embed(params, tokens, pos_idx)          # (slots, U)
        page_ids = tables.gather(1, (pos_idx // ps)[:, None])[:, 0].long()
        offsets = pos_idx % ps
        for i in range(self.layers):
            q, k, v = self._qkv(params, i, x, ad)
            pk = write_paged_rows(pool['l%d_k' % i], k, page_ids, offsets)
            pv = write_paged_rows(pool['l%d_v' % i], v, page_ids, offsets)
            ctx = flash_paged_decode_attention(q.contiguous(), pk, pv, tables,
                                               positions, heads=self.heads,
                                               scale=self.scale)
            x = self._attn_out_ffn(params, i, x, ctx, ad)
        return pool, self._head(params, x)

    def paged_verify(self, params, pool, tokens, positions, tables, ad=None):
        """The speculative verify: ``tokens`` (slots, C), the last accepted
        token and the draft's proposals, advance every slot C positions in
        one call, with logits at each. Causal within the chunk, each slot
        masked to its own history. Plain attention (the JAX package's
        einsum and softmax, no kernel): its sums run in another order than
        the one-token step's, so its logits agree with the step's to
        float32 precision, not bitwise; rejected rows stay masked until
        overwritten. ``ad``: one adapter a slot, as :meth:`step` takes
        it. Returns (pool, logits (slots, C, V))."""
        slots, C = tokens.shape
        ps = next(iter(pool.values())).shape[1]
        d = self.units // self.heads
        qpos = positions.long()[:, None] + torch.arange(
            C, device=tokens.device)[None, :]             # (S, C)
        x = self._embed(params, tokens, qpos)             # (S, C, U)
        page_ids = tables.long().gather(1, qpos // ps)
        offsets = qpos % ps
        ar = torch.arange(tables.shape[1] * ps, device=tokens.device)
        # query c of slot s sees key j iff j <= positions[s] + c
        bias = torch.where(ar[None, None, :] <= qpos[:, :, None],
                           0.0, -1e9)[:, None]           # (S, 1, C, Lp)
        for i in range(self.layers):
            q, k, v = self._qkv(params, i, x, ad)
            write_paged_chunk(pool['l%d_k' % i], k, page_ids, offsets)
            write_paged_chunk(pool['l%d_v' % i], v, page_ids, offsets)
            ck = gather_pages(pool['l%d_k' % i], tables)  # (S, Lp, U)
            cv = gather_pages(pool['l%d_v' % i], tables)
            qh = (q * self.scale).reshape(slots, C, self.heads, d) \
                .permute(0, 2, 1, 3)                      # (S, H, C, D)
            kh = ck.reshape(slots, -1, self.heads, d).permute(0, 2, 3, 1)
            vh = cv.reshape(slots, -1, self.heads, d).permute(0, 2, 1, 3)
            scores = torch.matmul(qh, kh) + bias          # (S, H, C, Lp)
            att = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
            att = att / att.sum(dim=-1, keepdim=True)
            ctx = torch.matmul(att, vh).permute(0, 2, 1, 3) \
                .reshape(slots, C, self.units)
            x = self._attn_out_ffn(params, i, x, ctx, ad)
        return pool, self._head(params, x)                # (S, C, V)


_FAMILIES = {RNNLM.family: RNNLM, TransformerLM.family: TransformerLM}


def model_from_config(family, config):
    """The decode model of ``family`` over ``config``: the factory a
    saved decode artifact's loader rebuilds its model through (the
    reference's ``model_from_config``, ``decode/model.py:669``); an
    unknown family raises ValueError."""
    cls = _FAMILIES.get(family)
    if cls is None:
        raise ValueError('unknown decode family %r (have %s)'
                         % (family, sorted(_FAMILIES)))
    return cls(config)


def init_transformer_lm(vocab, units=32, hidden=64, layers=2, heads=4,
                        max_len=64, seed=0):
    """Deterministic causal transformer LM: (model, params as a
    ``{name: ndarray}`` dict from ``seed``)."""
    model = TransformerLM(dict(vocab=vocab, units=units, hidden=hidden,
                               layers=layers, heads=heads,
                               max_len=max_len))
    return model, model.init_params(seed)


def init_rnn_lm(vocab, embed=32, hidden=64, layers=1, mode='lstm',
                max_len=128, seed=0):
    """Deterministic RNN LM: (model, params as a ``{name: ndarray}`` dict
    from ``seed``)."""
    model = RNNLM(dict(vocab=vocab, embed=embed, hidden=hidden,
                       layers=layers, mode=mode, max_len=max_len))
    return model, model.init_params(seed)


def _host(param):
    return param.detach().to('cpu', torch.float32).numpy()


def from_gluon_rnn_lm(embedding, rnn, decoder, max_len=128):
    """An (RNNLM, params) from the port's gluon blocks: ``Embedding`` ->
    ``gluon.rnn.LSTM`` / ``GRU`` / ``RNN`` -> ``Dense`` head. The flat
    vector is rebuilt in the layer's ``_flat_params`` order (every
    layer's weights, then its biases), so the decode cell reads the
    slices the fused op does. A bidirectional RNN raises ValueError, as
    does a head that does not map hidden to the vocabulary. The params
    are host arrays (``{name: ndarray}``)."""
    if rnn._dir != 1:
        raise ValueError('autoregressive decode needs a unidirectional '
                         'RNN (got bidirectional)')
    embed_w = _host(embedding.weight)
    vocab, embed_dim = embed_w.shape
    pieces = [_host(getattr(rnn, 'l%d_%s' % (layer, piece))).reshape(-1)
              for group in (('i2h_weight', 'h2h_weight'),
                            ('i2h_bias', 'h2h_bias'))
              for layer in range(rnn._num_layers) for piece in group]
    out_w = _host(decoder.weight)
    out_b = _host(decoder.bias) if decoder.bias is not None \
        else onp.zeros(out_w.shape[0], 'float32')
    if out_w.shape != (vocab, rnn._hidden_size):
        raise ValueError('decoder weight %r does not map hidden %d -> '
                         'vocab %d' % (out_w.shape, rnn._hidden_size, vocab))
    model = RNNLM(dict(vocab=vocab, embed=embed_dim, hidden=rnn._hidden_size,
                       layers=rnn._num_layers, mode=rnn._mode,
                       max_len=max_len))
    return model, {'embed_weight': embed_w,
                   'rnn_params': onp.concatenate(pieces),
                   'out_weight': out_w, 'out_bias': out_b}


def _config_from_params(shapes):
    """The TransformerLM config a params dict describes (heads and eps
    are not in the shapes; heads is checked by the caller's model)."""
    for need in ('embed', 'pos', 'l0_ffn1_w'):
        if need not in shapes:
            raise ValueError('params lack %r: not a TransformerLM params '
                             'dict' % need)
    vocab, units = shapes['embed']
    layers = 0
    while 'l%d_qkv_w' % layers in shapes:
        layers += 1
    return dict(vocab=vocab, units=units, hidden=shapes['l0_ffn1_w'][0],
                layers=layers, max_len=shapes['pos'][0])


def params_from_jax(np_params, device=None, model=None):
    """Carry a JAX decode model's weights over: ``{name: ndarray}`` (its
    ``init_params`` or ``DecodeProgram._params_np``) -> ``{name: float32
    tensor}`` on ``device`` (default cuda) under the same names.

    Both packages use the ``(out, in)`` weight layout (an RNNLM's
    ``rnn_params`` the same flat cuDNN layout), so no transposes are
    needed. With ``model`` every name and shape is checked against it;
    without, a TransformerLM dict is checked against the model its shapes
    describe, and an RNNLM dict (it holds ``rnn_params``; its mode and
    layers are not in the shapes) is left to the program's check against
    its model. Any mismatch raises ValueError."""
    device = resolve_device(device)
    shapes = {k: tuple(onp.shape(v)) for k, v in np_params.items()}
    if model is not None:
        model.check_shapes(shapes)
    elif 'rnn_params' not in shapes:
        cfg = _config_from_params(shapes)
        TransformerLM(dict(cfg, heads=1)).check_shapes(shapes)
    return {k: torch.as_tensor(onp.asarray(v, dtype='float32'),
                               device=device)
            for k, v in np_params.items()}

