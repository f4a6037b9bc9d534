"""Prompt-lookup (n-gram) speculative decoding (counterpart of
``multimodal_colpali_tpu/generation/speculative.py``).

vLLM's ``speculative_config={"method": "ngram"}``: a RAG answer copies spans
of its context, so drafts come free from the prompt itself.

1. **Draft** (:func:`_draft`): the tokens that followed the most recent
   earlier occurrence of the context's last ``ngram`` tokens, ``k`` of them
   (a vectorized compare over the token history; no draft model).
2. **Verify**: one forward over ``[last, d1 .. d_{k-1}]`` writes k K/V rows
   and gives k next-token distributions at once.
3. **Accept** the longest prefix of fed drafts that equals the greedy
   choice at the position before, plus the correction token: 1 to k tokens
   a forward. (JAX's acceptance is one draft off, F6 in ROADMAP.md: its
   streams can leave greedy decode where two drafts in a row differ; the
   port's cannot.)
   Rows written past the last accepted token are masked (dense) or left
   past the slot's length (paged) and overwritten before anything attends
   them.

Where JAX runs the whole generation as one ``lax.while_loop`` and each
batcher chunk as one ``lax.scan``, the port loops on the host, one verify
forward a step. In float32 on the CPU the streams equal greedy decode token
for token. On the card a k-row verify and a 1-row decode take different GEMM
tiles, so their bf16 roundings differ: a speculative reply equals the plain
one or first differs where the top two logits are nearly tied.

The batchers (:class:`SpeculativeContinuousBatcher`,
:class:`SpeculativePagedContinuousBatcher`) speculate per slot: greedy slots
accept drafts; sampled slots draft nothing and advance one token, sampled
at their own step index, so their streams equal the plain batcher's; a chunk
in which a slot asks for logprobs runs the parent's decode, after which the
draft history is rebuilt from the requests. The paged verify writes k rows
a slot by the block table and runs K7a / K7b once over ``[B * k, Hq, D]``
queries with the block table repeated and per-row lengths ``length + i + 1``.
A cross-decode engine's (Mllama's) blocks run in the verify forward over the
slots' cross pools (speculative.py:378-416): every verify row is a generated
token, so it attends all of its slot's cross rows, as a decode step does.
Over an engine's mesh both batchers verify tensor-parallel, and each data
rank verifies its own slots (the parent's ``_sl``), writing the dense
batcher's rows into its own slots' caches; the emitted windows and accepted
counts are all-gathered before the host state moves (speculative.py:
360-372). Admission records, the leader and ``follow`` are the parent's.
``speculative_generate`` over a mesh engine runs every row on every data
rank.
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import torch

from multimodal_colpali_tpu_torch.generation.engine import (
    attn_scale, layer_stack, left_pad, sample_per_slot)
from multimodal_colpali_tpu_torch.generation.paged import PagedContinuousBatcher
from multimodal_colpali_tpu_torch.generation.scheduler import ContinuousBatcher
from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_int8, quantize_kv_rows)

def _draft(tokens: torch.Tensor, first: torch.Tensor, cur_end: torch.Tensor, k: int,
           ngram: int, pad_id: int) -> torch.Tensor:
    """Prompt-lookup drafts ``[B, k]`` (speculative.py:37-71): ``tokens [B,
    T]`` holds each row's history from ``first``, valid up to ``cur_end``
    (exclusive). The most recent earlier occurrence of the trailing ngram
    with a whole k-token continuation inside the valid region proposes that
    continuation; a row with none drafts ``pad_id``."""
    b, t = tokens.shape
    dev = tokens.device
    tail = torch.gather(tokens, 1, (cur_end - ngram)[:, None] + torch.arange(ngram, device=dev))
    win = tokens.unfold(1, ngram, 1)                           # [B, T - ngram + 1, ngram]
    match = (win == tail[:, None, :]).all(dim=-1)
    pos = torch.arange(t - ngram + 1, device=dev)[None]
    ok = match & (pos >= first[:, None]) & (pos + ngram + k <= cur_end[:, None])
    best = torch.where(ok, pos, torch.full_like(pos, -1)).amax(dim=1)
    has = best >= 0
    start = torch.clamp(torch.where(has, best + ngram, torch.zeros_like(best)), max=t - k)
    out = torch.gather(tokens, 1, start[:, None] + torch.arange(k, device=dev))
    return torch.where(has[:, None], out, torch.full_like(out, pad_id))


def _accepted(drafts: torch.Tensor, greedy: torch.Tensor, k: int) -> torch.Tensor:
    """Drafts accepted a row (0..k-1): the longest prefix of the fed drafts
    ``drafts[:, :k-1]`` equal to the greedy choice at the position before
    each. JAX compares ``drafts[:, 1:]`` instead (speculative.py:176,
    :372), which accepts a window whose fed draft differs from the token it
    emits (ROADMAP.md, queue 3, F6)."""
    ok = drafts[:, : k - 1] == greedy[:, : k - 1]
    return torch.cumprod(ok.long(), dim=1).sum(dim=1)


def _emit(greedy: torch.Tensor, j: torch.Tensor, correction: torch.Tensor, k: int,
          pad_id: int) -> torch.Tensor:
    """Token i of a row's verify window: the greedy choice below ``j`` (the
    accepted draft), the correction at ``j``, ``pad_id`` past it."""
    ii = torch.arange(k, device=greedy.device)[None]
    return torch.where(ii < j[:, None], greedy,
                       torch.where(ii == j[:, None], correction[:, None],
                                   torch.full_like(greedy, pad_id)))


def _before_eos(emit: torch.Tensor, eos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(is eos ``[B, k]``, no eos before this token ``[B, k]``)."""
    is_eos = emit == eos
    earlier = torch.cumsum(torch.cat([torch.zeros_like(is_eos[:, :1]), is_eos[:, :-1]],
                                     dim=1).long(), dim=1)
    return is_eos, earlier == 0


@torch.inference_mode()
def speculative_generate(engine, prompts: Sequence[Sequence[int]], max_new_tokens: int = 64,
                         k: int = 4, ngram: int = 2, eos_id: int = -1, pad_id: int = 0,
                         bucket: int = 16) -> Tuple[List[List[int]], float]:
    """Greedy generation with prompt-lookup speculation (speculative.py:74-248)
    -> (token lists, as ``engine.generate`` greedy gives them, and the mean
    tokens emitted a verify forward)."""
    if not prompts:
        return [], 0.0
    c, p, dev = engine.cfg, engine.params, engine.device
    s = max(max(len(pr) for pr in prompts), ngram + 1)
    s = ((s + bucket - 1) // bucket) * bucket
    b = len(prompts)
    t_buf = s + max_new_tokens + k + 1
    ids, mask = (engine._tensor(a) for a in left_pad(prompts, s, pad_id))
    kc, vc = engine._caches(b, t_buf)
    first = s - mask.sum(dim=1)
    kv_valid = torch.cat([mask.bool(), torch.ones((b, t_buf - s), dtype=torch.bool,
                                                  device=dev)], dim=1)
    positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
    hidden, _ = engine._chunk(p, engine._embed(p, ids), positions, kc, vc, 0, kv_valid)
    tok0 = torch.argmax(engine._logits(p, hidden[:, -1]), dim=-1)
    tokens = torch.zeros((b, t_buf), dtype=torch.int64, device=dev)
    tokens[:, :s] = ids
    tokens[:, s] = tok0
    n_gen = torch.ones(b, dtype=torch.int64, device=dev)
    done = tok0 == eos_id
    last_pos = positions[:, -1]
    eos = torch.full((b, 1), eos_id, dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    ii = torch.arange(k, device=dev)[None]
    cols = torch.arange(t_buf, device=dev)
    sc = attn_scale(c)
    types = c.layer_types_resolved if getattr(c, "is_gemma3", False) else None
    n_fwd = n_acc = 0
    while bool((~done & (n_gen < max_new_tokens)).any()):
        cur_end = s + n_gen
        drafts = _draft(tokens, first, cur_end, k, ngram, pad_id)
        last = torch.gather(tokens, 1, (cur_end - 1)[:, None])
        fed = torch.cat([last, drafts[:, : k - 1]], dim=1)
        wcols = (s + n_gen - 1)[:, None] + ii                   # the last token's row on
        amask = (kv_valid[:, None, :] & (cols[None, None, :] <= wcols[:, :, None]))[:, None]
        if types is not None:
            sl_mask = amask & (cols[None, None, None, :]
                               > (wcols[:, :, None] - c.sliding_window)[:, None])

        def kv_write(i, kk, vv):
            kc[i][rows, wcols] = kk
            vc[i][rows, wcols] = vv
            return kc[i], vc[i]

        def attend(i, q, kcc, vcc):
            m = sl_mask if types is not None and types[i] == "sliding_attention" else amask
            return L.attention(q, kcc, vcc, mask=m, scale=sc)

        hidden, _ = layer_stack(p, c, engine._embed(p, fed), (last_pos + n_gen)[:, None] + ii,
                                kv_write, attend)
        greedy = torch.argmax(engine._logits(p, hidden.reshape(b * k, -1)).reshape(b, k, -1),
                              dim=-1)
        j = _accepted(drafts, greedy, k)
        emit = _emit(greedy, j, torch.gather(greedy, 1, j[:, None])[:, 0], k, pad_id)
        can = (ii <= j[:, None]) & ~done[:, None] & (n_gen[:, None] + ii < max_new_tokens)
        is_eos, clear = _before_eos(emit, eos)
        can = can & clear
        n_emit = can.sum(dim=1)
        at = cur_end[:, None] + ii
        tokens.scatter_(1, at, torch.where(can, emit, torch.gather(tokens, 1, at)))
        n_fwd += int((~done).sum())
        n_acc += int(n_emit.sum())
        n_gen = torch.clamp(n_gen + n_emit, max=max_new_tokens)
        done = done | (is_eos & can).any(dim=1) | (n_gen >= max_new_tokens)
    toks = tokens[:, s:].cpu().numpy()
    counts = n_gen.cpu().numpy()
    results: List[List[int]] = []
    for i in range(b):
        row = toks[i, : int(counts[i])].tolist()
        if eos_id in row:
            row = row[: row.index(eos_id)]
        results.append(row)
    return results, n_acc / max(n_fwd, 1)


class _SpecHostMixin:
    """What both speculative batchers share (speculative.py:314-440): the
    token history drafts are looked up in (``[B, width]`` on the device, its
    valid length per slot), the verify step, and the accounting of variable
    acceptance into request state. A subclass supplies ``_verify_kv(active)``
    -> (kv_write, attend) for the ``[B, k]`` window and ``_grow(n_emit)``,
    which moves its K/V length."""

    def __init__(self, *args, spec_k: int = 4, spec_ngram: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self._spec_dirty = False
        self._toks_dev = torch.zeros((self.B, self._spec_buf_width()), dtype=torch.int64,
                                     device=self.device)
        self._nlen = torch.zeros(self.B, dtype=torch.int64, device=self.device)
        self.spec_forwards = 0
        self.spec_accepted = 0

    def _spec_buf_width(self) -> int:
        return self.T

    def _slot_capacity(self, s: int) -> int:
        # the verify window may write spec_k - 1 stale rows past the last
        # accepted token: that slack stays out of the budget
        return super()._slot_capacity(s) - (self.spec_k - 1)

    def _finish_admission(self, slot, req, s, prompt_eff, *a, **kw) -> None:
        super()._finish_admission(slot, req, s, prompt_eff, *a, **kw)
        self._set_history(slot, list(prompt_eff) + list(req.tokens[-1:]))

    def _set_history(self, slot: int, row: List[int]) -> None:
        if len(row) > self._toks_dev.shape[1]:
            raise RuntimeError(f"slot history of {len(row)} tokens exceeds the draft buffer "
                               f"({self._toks_dev.shape[1]})")
        self._toks_dev[slot, : len(row)] = self._tensor(row, torch.int64)
        self._nlen[slot] = len(row)

    def _sync_spec_history(self) -> None:
        """Rebuild the draft history from the requests after chunks that ran
        the parent's decode (logprobs): that path leaves it stale."""
        if not self._spec_dirty:
            return
        self._spec_dirty = False
        for slot, req in enumerate(self._slots):
            if req is not None:
                self._set_history(slot, list(req.prompt) + list(req.tokens))

    def _verify_step(self, p, with_filter: bool, sampled: bool):
        """One verify forward for every slot -> (emit, can ``[B, k]``, active
        ``[B]``); advances the per-slot state by each slot's accepted count."""
        eng, c, k, sl = self.engine, self.cfg, self.spec_k, self._sl
        dev = self.device
        active = self._remaining > 0
        drafts = _draft(self._toks_dev[sl], torch.zeros_like(self._nlen[sl]),
                        torch.clamp(self._nlen[sl], min=self.spec_ngram), k, self.spec_ngram,
                        self.pad_id)
        fed = torch.cat([self._tok[sl].long()[:, None], drafts[:, : k - 1]], dim=1)
        b = fed.shape[0]
        ii = torch.arange(k, device=dev)[None]
        kv_write, attend = self._verify_kv(active)
        xx, _ = layer_stack(p, c, eng._embed(p, fed), self._pos[sl][:, None] + ii, kv_write,
                            attend, interleave=self._cross_hooks())
        logits = eng._logits(p, xx.reshape(b * k, -1)).reshape(b, k, -1)
        greedy = torch.argmax(logits, dim=-1)
        j = _accepted(drafts, greedy, k)
        correction = torch.gather(greedy, 1, j[:, None])[:, 0]
        if sampled:
            # sampled slots: no drafts, the first position's token sampled at
            # the slot's own step, as the plain batcher samples it
            temp = self._temp[sl]
            j = torch.where(temp > 0, torch.zeros_like(j), j)
            corr_t = sample_per_slot(logits[:, 0], self._seed[sl], self._gen_step[sl], temp,
                                     self._top_p[sl], self._top_k[sl],
                                     use_filter=with_filter).long()
            correction = torch.where(temp > 0, corr_t, torch.gather(greedy, 1, j[:, None])[:, 0])
        emit, j = self._gather(_emit(greedy, j, correction, k, self.pad_id)), self._gather(j)
        can = (ii <= j[:, None]) & active[:, None] & (ii < self._remaining[:, None])
        is_eos, clear = _before_eos(emit, self._eos[:, None])
        can = can & clear
        n_emit = can.sum(dim=1)
        hit_eos = (is_eos & can).any(dim=1)
        at = torch.clamp(self._nlen[:, None] + ii, max=self._toks_dev.shape[1] - 1)
        self._toks_dev.scatter_(1, at, torch.where(can, emit, torch.gather(self._toks_dev, 1,
                                                                           at)))
        last = torch.gather(emit, 1, torch.clamp(n_emit - 1, min=0)[:, None])[:, 0]
        self._tok = torch.where(n_emit > 0, last, self._tok.long()).to(torch.int32)
        self._nlen = self._nlen + n_emit
        self._grow(n_emit)
        self._pos = self._pos + n_emit
        self._gen_step = self._gen_step + n_emit
        self._remaining = torch.clamp(self._remaining - n_emit, min=0)
        self._remaining = torch.where(hit_eos, torch.zeros_like(self._remaining),
                                      self._remaining)
        return emit, can, active

    def _spec_chunk(self) -> None:
        """``chunk`` verify steps, then the sync into per-request state."""
        t0 = time.perf_counter()
        with_filter = self._decode_flags()[0]
        sampled = any(r is not None and r.temperature > 0 for r in self._slots)
        ys = [self._verify_step(self.engine.params, with_filter, sampled)
              for _ in range(self.chunk)]
        self._account_spec_chunk(tuple(torch.stack(y) for y in zip(*ys)))
        self.decode_s += time.perf_counter() - t0
        self.decode_steps += self.chunk

    def _account_spec_chunk(self, ys) -> None:
        emit, can, active = (y.cpu().numpy() for y in ys)
        self.spec_forwards += int(active.sum())
        self.spec_accepted += int(can.sum())
        remaining = self._remaining.cpu().numpy()
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            done = False
            for step in range(emit.shape[0]):
                for i in range(emit.shape[2]):
                    if not can[step, slot, i]:
                        continue
                    tok = int(emit[step, slot, i])
                    req.tokens.append(tok)
                    self.decode_tokens += 1
                    if tok == req.eos_id:
                        done = True
                        break
                if done:
                    break
            self._emit_stream(req)
            if (remaining[slot] <= 0 or len(req.tokens) >= req.max_new_tokens
                    or (req.tokens and req.tokens[-1] == req.eos_id)):
                self._finish(slot)


class SpeculativeContinuousBatcher(_SpecHostMixin, ContinuousBatcher):
    """The dense batcher with per-slot prompt-lookup speculation
    (speculative.py:251-271, :427-565): admission, prefill, streaming and
    failure recovery are the parent's; each decode step verifies ``spec_k``
    tokens a slot and advances each slot by its own accepted count."""

    def _verify_kv(self, active):
        c, t, k, sl = self.cfg, self.T, self.spec_k, self._sl
        dev = self.device
        rows = torch.arange(self._b_local, device=dev)[:, None]   # this rank's cache rows
        wcols = self._end[sl][:, None] + torch.arange(k, device=dev)[None]
        safe = torch.clamp(wcols, 0, t - 1)
        cols = torch.arange(t, device=dev)
        base = ((cols[None, None, :] >= self._start[sl][:, None, None])
                & (cols[None, None, :] <= wcols[:, :, None]))[:, None]     # [B, 1, k, T]
        types = c.layer_types_resolved if getattr(c, "is_gemma3", False) else None
        if types is not None:
            sw = base & (cols[None, None, None, :] > (wcols[:, :, None] - c.sliding_window)
                         [:, None])
        sc = attn_scale(c)

        def kv_write(i, kk, vv):
            self._kc[i][rows, safe] = kk
            self._vc[i][rows, safe] = vv
            return self._kc[i], self._vc[i]

        def attend(i, q, kc, vc):
            m = sw if types is not None and types[i] == "sliding_attention" else base
            return L.attention(q, kc, vc, mask=m, scale=sc)

        return kv_write, attend

    def _grow(self, n_emit) -> None:
        self._end = self._end + n_emit

    def _step_chunk(self) -> None:
        if self._decode_flags()[1]:      # logprobs wanted: the parent's exact decode
            super()._step_chunk()
            self._spec_dirty = True
            return
        self._sync_spec_history()
        self._spec_chunk()


class SpeculativePagedContinuousBatcher(_SpecHostMixin, PagedContinuousBatcher):
    """Prompt-lookup speculation over the paged KV pool (speculative.py:
    274-303, :567-822). Admission, page grants, preemption with recompute,
    prefix caching and int8 pools are the parent's; the verify scatters
    ``spec_k`` K/V rows a slot to (page, row) by the block table (inactive
    slots to the write-off page 0) and attends with one K7a / K7b call over
    the ``B * spec_k`` queries. Page accounting covers the stale rows:
    ``spec_k - 1`` rows of slack a slot, and each chunk grants pages for up
    to ``chunk * spec_k`` accepted tokens plus the slack."""

    def _spec_buf_width(self) -> int:
        return self.NB * self.page + self.spec_k

    def _chunk_rows(self, rem: int) -> int:
        return min(self.chunk * self.spec_k, rem) + self.spec_k - 1

    def _verify_kv(self, active):
        k, page, nb, sl = self.spec_k, self.page, self.NB, self._sl
        dev = self.device
        bt = self._bt[sl]
        b = bt.shape[0]
        active, length = active[sl], self._len[sl]
        ii = torch.arange(k, device=dev)[None]
        wtok = length[:, None] + ii                     # logical row of verify token i
        blk = bt[torch.arange(b, device=dev)[:, None], torch.clamp(wtok // page, 0, nb - 1)]
        blk = torch.where(active[:, None], blk, torch.zeros_like(blk))   # write-off page
        off = wtok % page
        # query i attends the slot's rows up to its own
        att_len = torch.where(active[:, None], wtok + 1, length[:, None]).to(torch.int32)
        btf = bt.repeat_interleave(k, dim=0)            # [B * k, NB]
        alf = att_len.reshape(-1)
        sc = attn_scale(self.cfg)
        kp_all, vp_all = self._kpools, self._vpools

        if self.kv_dtype == "int8":
            def kv_write(i, kk, vv):
                kc, ks = quantize_kv_rows(kk)
                vc, vs = quantize_kv_rows(vv)
                kp_all[i][0][blk, off] = kc
                kp_all[i][1][blk, off] = ks
                vp_all[i][0][blk, off] = vc
                vp_all[i][1][blk, off] = vs
                return kp_all[i], vp_all[i]

            def attend(i, q, kp, vp):
                out = paged_attention_int8(q.reshape((b * k,) + q.shape[2:]), kp[0], kp[1],
                                           vp[0], vp[1], btf, alf, scale=sc,
                                           window=self._layer_window(i))
                return out.reshape(b, k, -1)
        else:
            def kv_write(i, kk, vv):
                kp_all[i][blk, off] = kk
                vp_all[i][blk, off] = vv
                return kp_all[i], vp_all[i]

            def attend(i, q, kp, vp):
                out = paged_attention(q.reshape((b * k,) + q.shape[2:]), kp, vp, btf, alf,
                                      scale=sc, window=self._layer_window(i))
                return out.reshape(b, k, -1)

        return kv_write, attend

    def _grow(self, n_emit) -> None:
        self._len = self._len + n_emit

    def _step_chunk(self) -> None:
        if self._decode_flags()[1]:      # logprobs wanted: the parent's exact paged decode
            super()._step_chunk()
            self._spec_dirty = True
            return
        self._sync_spec_history()
        self._ensure_chunk_capacity()
        if not self._busy():
            return
        self._bt = self._tensor(self._bt_host, torch.int32)
        self._spec_chunk()


