"""Paged-KV continuous batching (counterpart of
``multimodal_colpali_tpu/generation/paged.py:46-810``).

``ContinuousBatcher`` keeps a dense ``[B, max_seq_len]`` cache per slot;
``PagedContinuousBatcher`` keeps one pool of fixed-size pages shared by the
slots plus a block table per slot, so device memory holds only the pages
requests use (vLLM's PagedAttention memory model). On top of the parent:

- pages are granted per decode chunk, not for a request's whole budget;
- when the pool runs dry the youngest active request is preempted (its
  pages freed) and requeued; on readmission its prompt and the tokens it
  generated re-prefill and sampling resumes at its own step, so its stream
  equals an uninterrupted run (recompute preemption);
- ``prefix_caching=True`` shares full prompt pages between requests by
  content (refcounted, with an LRU of unreferenced cached pages), and a
  prompt with a cached prefix prefills only its tail;
- ``kv_dtype="int8"`` keeps the pools as int8 codes plus one float32 scale
  per (token, kv head);
- image requests (``mm_engine``) page like text ones once prefilled. With
  ``prefix_caching`` a ``Gemma3MMEngine``'s prompts share pages too, keyed
  by the pixels' digest in the chain root, when every image span has exactly
  ``mm_tokens_per_image`` tokens: its prompt is causal and each span's soft
  tokens are fixed by the digest, so a page's K/V depend only on what comes
  before its end. PaliGemma's prompts never share: they attend
  bidirectionally, so a page's K/V depend on the whole prompt
  (paged.py:127-137). Nor do a cross-decode engine's (Mllama): its image
  context lives in the per-slot cross pools, not in prompt pages;
- a cross-decode engine's per-slot cross pools are the parent's, and a
  preempted image request's rows are packed again at readmission.

The decode step is the parent's layer math with two substitutions: K/V rows
go to (page, row) from the block table, updated in place with ``index_put_``
(JAX donates the pools instead), and attention is K7a (native pools) or K7b
(int8 pools) on the card, their plain versions on the CPU. The dense caches
of the parent are never allocated. Physical page 0 is a write-off page:
inactive slots write there, so the step needs no branch.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, List, Optional

import numpy as np
import torch

from multimodal_colpali_tpu_torch.generation.engine import GemmaDecodeEngine, attn_scale
from multimodal_colpali_tpu_torch.generation.scheduler import ContinuousBatcher
from multimodal_colpali_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_int8, quantize_kv_rows)


class PagedContinuousBatcher(ContinuousBatcher):
    """Slot-based continuous batching over a shared paged KV pool."""

    def __init__(self, engine: GemmaDecodeEngine, batch_slots: int = 4,
                 max_seq_len: int = 512, chunk: int = 8, prompt_bucket: int = 16,
                 eos_id: int = -1, pad_id: int = 0, prefill_cache_entries: int = 8,
                 mm_engine: Any = None, page_size: int = 16, pool_pages: Optional[int] = None,
                 kv_dtype: str = "native", prefix_caching: bool = False,
                 prefill_chunk: int = 0, max_queue: int = 0, admission_timeout: float = 0.0,
                 cross_max_images: int = 1):
        """``pool_pages`` sizes the pool (default: every slot can reach
        ``max_seq_len``); ``page_size`` tokens per page. See the module
        docstring for ``kv_dtype`` and ``prefix_caching``."""
        if kv_dtype not in ("native", "int8"):
            raise ValueError(f"kv_dtype must be 'native' or 'int8', got {kv_dtype!r}")
        self.page = page_size
        self.NB = -(-max_seq_len // page_size)          # blocks per slot
        if pool_pages is None:
            pool_pages = batch_slots * self.NB + 1
        self.P = max(pool_pages, 2)
        self.kv_dtype = kv_dtype
        super().__init__(engine, batch_slots, max_seq_len, chunk, prompt_bucket, eos_id,
                         pad_id, prefill_cache_entries, mm_engine, prefill_chunk=prefill_chunk,
                         max_queue=max_queue, admission_timeout=admission_timeout,
                         cross_max_images=cross_max_images)
        self._len = torch.zeros(self.B, dtype=torch.int64, device=self.device)
        self._reset_allocator()
        self._admit_seq = 0
        self._slot_age = [0] * self.B                   # admission order
        self.preemptions = 0
        self.prefix_caching = prefix_caching
        # image prompts share pages only where the engine declares it sound
        self._mm_prefix_ok = (prefix_caching and mm_engine is not None
                              and mm_engine.shares_prefix_pages and not self._cross_mode)
        self.prefix_cache_hits = 0
        self.prefix_prefill_hits = 0   # tail-only prefills (prefix compute skipped)

    def _init_kv(self) -> None:
        """Zeroed page pools, one (k, v) per layer; int8 pools are (codes, scales)."""
        c = self.cfg
        self._kpools = self._vpools = None   # release old pools before the new ones
        shape = (self.P, self.page, c.num_key_value_heads, c.head_dim)

        def pool():
            if self.kv_dtype == "int8":
                return (torch.zeros(shape, dtype=torch.int8, device=self.device),
                        torch.zeros(shape[:-1], dtype=torch.float32, device=self.device))
            return torch.zeros(shape, dtype=self.engine.dtype, device=self.device)

        self._kpools = [pool() for _ in range(c.num_hidden_layers)]
        self._vpools = [pool() for _ in range(c.num_hidden_layers)]

    def _reset_allocator(self) -> None:
        """Host-side allocator state; page 0 is the write-off page."""
        self._free: List[int] = list(range(self.P - 1, 0, -1))
        self._slot_pages: List[List[int]] = [[] for _ in range(self.B)]
        self._bt_host = np.zeros((self.B, self.NB), np.int32)
        self._page_ref = [0] * self.P                   # live holders per page
        self._page_key: dict = {}                       # phys -> chain key
        self._key_page: dict = {}                       # chain key -> phys
        self._cache_lru: "OrderedDict[int, None]" = OrderedDict()  # cached, ref 0

    # -- allocator ----------------------------------------------------------------

    def _alloc_page(self) -> Optional[int]:
        """A fresh private page: the free list first, then the least recently
        used unreferenced cached page (its content key dropped)."""
        if self._free:
            return self._free.pop()
        if self._cache_lru:
            phys, _ = self._cache_lru.popitem(last=False)
            key = self._page_key.pop(phys, None)
            if key is not None:
                self._key_page.pop(key, None)
            return phys
        return None

    def _free_now(self) -> int:
        return len(self._free) + len(self._cache_lru)

    def _attach(self, slot: int, phys: int) -> None:
        pages = self._slot_pages[slot]
        self._bt_host[slot, len(pages)] = phys
        pages.append(phys)
        self._page_ref[phys] += 1
        self._cache_lru.pop(phys, None)

    def _alloc_to(self, slot: int, n_tokens: int) -> bool:
        """Grow the slot's pages to cover ``n_tokens``; False if the pool is dry."""
        need = -(-n_tokens // self.page)
        if need > self.NB:
            return False
        pages = self._slot_pages[slot]
        while len(pages) < need:
            phys = self._alloc_page()
            if phys is None:
                return False
            self._attach(slot, phys)
        return True

    def _release(self, slot: int) -> None:
        for phys in reversed(self._slot_pages[slot]):
            self._page_ref[phys] -= 1
            if self._page_ref[phys] == 0:
                if phys in self._page_key:
                    self._cache_lru[phys] = None   # cached content stays, evictable
                else:
                    self._free.append(phys)
        self._slot_pages[slot] = []
        self._bt_host[slot] = 0

    def _preempt_youngest(self, protect: int) -> bool:
        """Send the most recently admitted active slot (never ``protect``)
        back to the readmission queue."""
        victim, best = -1, -1
        for slot, req in enumerate(self._slots):
            if req is not None and slot != protect and self._slot_age[slot] > best:
                victim, best = slot, self._slot_age[slot]
        if victim < 0:
            return False
        req = self._slots[victim]
        self._slots[victim] = None
        self._release(victim)
        self._remaining[victim] = 0
        self._len[victim] = 0
        self._reset_cross(victim)       # its cross rows are packed again at readmission
        self._readmit.insert(0, req)
        self.preemptions += 1
        return True

    # -- cached-prefix tail prefill -------------------------------------------------

    def _chain_keys(self, tokens, ctx):
        """Chain keys of the prompt's full pages."""
        keys: List[Any] = []
        chain: Any = ("root", ctx)
        for i in range(len(tokens) // self.page):
            chain = (chain, tuple(tokens[i * self.page:(i + 1) * self.page]))
            keys.append(chain)
        return keys

    def _mm_spans_ok(self, tokens) -> bool:
        """Whether every image-token run of ``tokens`` has exactly the
        engine's ``tokens_per_image`` tokens (paged.py:276-292): only then do
        the digest and the tokens so far fix the soft tokens and the positions
        a page holds. A malformed prompt (a truncated run) shares nothing.
        (JAX reads ``cfg.mm_tokens_per_image``, which only Gemma-3's config
        has: a Qwen2-VL or LLaVA-NeXT image prompt under prefix caching raises
        ``AttributeError`` there.)"""
        img, per = self.mm_engine.cfg.image_token_id, self.mm_engine.tokens_per_image
        run = 0
        for t in tokens:
            if t == img:
                run += 1
            elif run:
                if run != per:
                    return False
                run = 0
        return run in (0, per)

    def _shares(self, tokens, mm: bool) -> bool:
        """Whether a prompt takes part in prefix caching: text always, an
        image prompt where :meth:`_mm_spans_ok` and the engine allow it."""
        return not mm or (self._mm_prefix_ok and self._mm_spans_ok(tokens))

    def _reuse_depth(self, keys, n_prompt: int) -> int:
        """Leading pages whose keys are cached, capped so the tail keeps at
        least one token (the next-token logits come from it)."""
        n = 0
        for key in keys:
            if key not in self._key_page:
                break
            n += 1
        if n * self.page >= n_prompt:
            n = max((n_prompt - 1) // self.page, 0)
        return n

    def _gather_pages(self, pools, phys: torch.Tensor) -> torch.Tensor:
        """The rows of pages ``phys`` as ``[1, n * page, Hkv, D]`` in the model dtype."""
        c = self.cfg
        if self.kv_dtype == "int8":
            rows = (pools[0][phys].float() * pools[1][phys][..., None]).to(self.engine.dtype)
        else:
            rows = pools[phys]
        return rows.reshape(1, -1, c.num_key_value_heads, c.head_dim)

    def _prefix_prefill(self, prompt_eff, ctx, mm):
        """Prefill only the prompt tail against cached prefix pages
        (paged.py:294-389). The tail sits right after the context rows, so
        slot distance equals token distance and Gemma-3's sliding masks stay
        true; the returned rows are right-aligned again for install. An image
        prompt (``ctx``, its pixel digest, in the chain root) takes part when
        it shares pages and its tail holds no image token; otherwise the
        whole prompt prefills."""
        if not self.prefix_caching or not self._shares(prompt_eff, mm):
            return None
        page, eng, c = self.page, self.engine, self.cfg
        n_prompt = len(prompt_eff)
        keys = self._chain_keys(prompt_eff, ctx)
        n_reused = self._reuse_depth(keys, n_prompt)
        if n_reused == 0:
            return None
        n_ctx = n_reused * page
        tail = prompt_eff[n_ctx:]
        if mm and self.mm_engine.cfg.image_token_id in tail:
            return None      # an image span in the tail needs the image prefill
        n_tail = len(tail)
        s_tail = max(((n_tail + self.bucket - 1) // self.bucket) * self.bucket, self.bucket)
        phys = self._tensor([self._key_page[k] for k in keys[:n_reused]], torch.int64)
        total = n_ctx + s_tail
        shape = (1, total, c.num_key_value_heads, c.head_dim)
        kc, vc = [], []
        for kp, vp in zip(self._kpools, self._vpools):
            k0 = torch.zeros(shape, dtype=eng.dtype, device=self.device)
            v0 = torch.zeros(shape, dtype=eng.dtype, device=self.device)
            k0[:, :n_ctx] = self._gather_pages(kp, phys)
            v0[:, :n_ctx] = self._gather_pages(vp, phys)
            kc.append(k0)
            vc.append(v0)
        mask = torch.zeros((1, s_tail), dtype=torch.int64, device=self.device)
        mask[0, :n_tail] = 1
        ids = torch.full((1, s_tail), self.pad_id, dtype=torch.int64, device=self.device)
        ids[0, :n_tail] = self._tensor(tail, torch.int64)
        if mm:
            # the tail is text: its position continues the image prompt's
            # (mrope's largest stream for Qwen2-VL), counted over the whole prompt
            full = self._tensor([prompt_eff], torch.int64)
            pos = self.mm_engine.prompt_positions(full, torch.ones_like(full))[0, n_ctx:]
            positions = torch.cat([pos, pos[-1] + torch.cumsum(mask[0, n_tail:], 0)])[None]
        else:
            positions = torch.clamp(n_ctx + torch.cumsum(mask, dim=1) - 1, min=0)
        kv_valid = torch.cat([torch.ones((1, n_ctx), dtype=torch.bool, device=self.device),
                              mask.bool()], dim=1)
        hidden, (k, v) = eng._chunk(eng.params, eng._embed(eng.params, ids), positions, kc, vc,
                                    n_ctx, kv_valid)
        k_tail = tuple(torch.roll(kk[:, n_ctx:], s_tail - n_tail, dims=1) for kk in k)
        v_tail = tuple(torch.roll(vv[:, n_ctx:], s_tail - n_tail, dims=1) for vv in v)
        logits = eng._logits(eng.params, hidden[:, n_tail - 1])[0]
        self.prefix_prefill_hits += 1
        return (k_tail, v_tail, logits, int(positions[0, n_tail - 1]),
                ("tail", n_reused, s_tail, keys))

    # -- ContinuousBatcher hooks ------------------------------------------------------

    def _can_admit(self, s: int, n_prompt: int, budget: int, tokens=None, mm: bool = False,
                   ctx=None) -> bool:
        """Admit only requests that fit the free pool now and could finish
        with the pool to themselves (paged.py:393-447). Peak demand is
        ``n_prompt + budget - 1`` rows; cached prefix pages need no fresh page."""
        usable = self.P - 1
        budget_c = min(budget, self._slot_capacity(s))
        worst_rows = n_prompt if budget_c <= 1 else n_prompt + budget_c - 1
        if -(-worst_rows // self.page) > min(usable, self.NB):
            return False
        n_reused = reused_in_lru = 0
        if self.prefix_caching and tokens is not None and self._shares(tokens, mm):
            keys = self._chain_keys(tokens, ctx)
            n_reused = self._reuse_depth(keys, n_prompt)
            reused_in_lru = sum(self._key_page[k] in self._cache_lru for k in keys[:n_reused])
        need_fresh = -(-n_prompt // self.page) - n_reused
        avail = self._free_now() - reused_in_lru
        return need_fresh <= min(avail, self.NB - n_reused)

    def _slot_capacity(self, s: int) -> int:
        return self.NB * self.page - s

    def _install_slot(self, slot: int, s: int, n_prompt: int, k, v, tokens=None, ctx=None,
                      hint=None) -> None:
        """Scatter the prefill rows (left-padded to ``s``, or the tail rows
        of a prefix prefill) into the slot's pages, valid tokens first:
        logical token t lands at page t // page, row t % page. Cached full
        pages are attached read-only and newly written full pages registered
        under their chain keys (paged.py:452-562). An image request
        (``ctx``, its pixel digest, in the chain root) shares pages only where
        :meth:`_shares` allows it."""
        page = self.page
        n_pages = -(-n_prompt // page)
        keys: List[Any] = []
        n_reused = 0
        if self.prefix_caching and tokens is not None and self._shares(tokens, ctx is not None):
            keys = hint[3] if hint is not None else self._chain_keys(tokens, ctx)
            if hint is not None:
                n_reused = hint[1]
                for key in keys[:n_reused]:
                    self._attach(slot, self._key_page[key])
            else:
                for key in keys:
                    phys = self._key_page.get(key)
                    if phys is None:
                        break
                    self._attach(slot, phys)
                    n_reused += 1
            self.prefix_cache_hits += n_reused
        if not self._alloc_to(slot, n_prompt):
            raise RuntimeError("admission without capacity")  # _can_admit gates this
        phys_new = self._slot_pages[slot][n_reused:]
        if phys_new:
            src_s = hint[2] if hint is not None else s
            n_valid = n_prompt - n_reused * page if hint is not None else n_prompt
            skip = 0 if hint is not None else n_reused * page
            n_new = n_pages - n_reused
            full = skip + n_new * page
            phys = self._tensor(phys_new, torch.int64)
            for kp, vp, ki, vi in zip(self._kpools, self._vpools, k, v):
                for pool, src in ((kp, ki), (vp, vi)):
                    rows = torch.roll(src[0], n_valid - src_s, dims=0)
                    if full > src_s:
                        pad = rows.new_zeros((full - src_s,) + tuple(rows.shape[1:]))
                        rows = torch.cat([rows, pad], dim=0)
                    rows = rows[skip:full]
                    rows = rows.reshape((n_new, page) + tuple(rows.shape[1:]))
                    if self.kv_dtype == "int8":
                        codes, scales = quantize_kv_rows(rows)
                        pool[0][phys] = codes
                        pool[1][phys] = scales
                    else:
                        pool[phys] = rows
            for i in range(n_reused, len(keys)):
                ph = self._slot_pages[slot][i]
                if keys[i] not in self._key_page:
                    self._key_page[keys[i]] = ph
                    self._page_key[ph] = keys[i]
        self._len[slot] = n_prompt
        self._slot_age[slot] = self._admit_seq
        self._admit_seq += 1

    def _finish(self, slot: int) -> None:
        self._release(slot)
        self._len[slot] = 0
        super()._finish(slot)

    def _fail_all(self, exc: BaseException) -> None:
        """Release every slot and rebuild fresh zero pools and allocator
        state before failing the futures (paged.py:569-612): a step that
        failed part-way may have left the pools half-written, and the prefix
        cache lives in them."""
        self._remaining = torch.zeros_like(self._remaining)
        self._len = torch.zeros_like(self._len)
        self._init_kv()
        self._reset_allocator()
        super()._fail_all(exc)

    # -- decode ---------------------------------------------------------------------

    def _layer_window(self, i: int) -> int:
        """0 = full causal; else the layer's sliding window (Gemma-3 local layers)."""
        c = self.cfg
        if getattr(c, "is_gemma3", False) and c.layer_types_resolved[i] == "sliding_attention":
            return int(c.sliding_window)
        return 0

    def _one_step(self, p):
        """One decode token per slot with paged K/V writes and paged attention
        (paged.py:648-728)."""
        page, sl = self.page, self._sl
        bt = self._bt[sl]
        active_all = self._remaining > 0
        active = active_all[sl]
        rows = torch.arange(bt.shape[0], device=self.device)
        length = self._len[sl]
        blk = bt[rows, torch.clamp(length // page, max=self.NB - 1)]
        blk = torch.where(active, blk, torch.zeros_like(blk))   # write-off page
        off = length % page
        att_len = (length + active.long()).to(torch.int32)
        sc = attn_scale(self.cfg)
        kp_all, vp_all = self._kpools, self._vpools

        if self.kv_dtype == "int8":
            def kv_write(i, k, v):
                kc, ks = quantize_kv_rows(k[:, 0])
                vc, vs = quantize_kv_rows(v[:, 0])
                kp_all[i][0][blk, off] = kc
                kp_all[i][1][blk, off] = ks
                vp_all[i][0][blk, off] = vc
                vp_all[i][1][blk, off] = vs
                return kp_all[i], vp_all[i]

            def attend(i, q, kp, vp):
                return paged_attention_int8(q[:, 0], kp[0], kp[1], vp[0], vp[1], bt, att_len,
                                            scale=sc, window=self._layer_window(i))
        else:
            def kv_write(i, k, v):
                kp_all[i][blk, off] = k[:, 0]
                vp_all[i][blk, off] = v[:, 0]
                return kp_all[i], vp_all[i]

            def attend(i, q, kp, vp):
                return paged_attention(q[:, 0], kp, vp, bt, att_len, scale=sc,
                                       window=self._layer_window(i))

        out = self._decode_step(p, kv_write, attend)
        self._len = self._len + active_all.long()
        return out

    def _chunk_rows(self, rem: int) -> int:
        """KV rows one decode chunk may append for a slot with ``rem`` budget left."""
        return min(self.chunk, rem)

    def _ensure_chunk_capacity(self) -> None:
        """Grant every active slot pages for the coming chunk, oldest first,
        preempting the youngest when the pool runs dry."""
        order = sorted((slot for slot, r in enumerate(self._slots) if r is not None),
                       key=lambda slot: self._slot_age[slot])
        lens = self._len.cpu().numpy()
        rem = self._remaining.cpu().numpy()
        for slot in order:
            if self._slots[slot] is None:   # preempted by an earlier pass
                continue
            want = int(lens[slot]) + self._chunk_rows(int(rem[slot]))
            while not self._alloc_to(slot, want):
                if not self._preempt_youngest(protect=slot):
                    raise RuntimeError(f"slot {slot} needs {want} tokens of KV but the pool "
                                       f"cannot hold them even alone")

    def _step_chunk(self) -> None:
        self._ensure_chunk_capacity()
        if not self._busy():
            return
        self._bt = self._tensor(self._bt_host, torch.int32)
        self._run_chunk()
