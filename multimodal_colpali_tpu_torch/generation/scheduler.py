"""Continuous batching for the decode engine (counterpart of
``multimodal_colpali_tpu/generation/scheduler.py:42-1082``, the text paths).

``batch_slots`` sequences decode in lockstep; per-slot write indices,
positions, temperatures, seeds and budgets are device tensors, so one decode
step serves requests that differ in all of them. Between scheduling points
the batcher decodes ``chunk`` tokens; a new request prefills its own
(bucketed) prompt once and its K/V rows are copied into its slot while the
other slots keep decoding. ``submit()`` returns a Future; ``serve()`` runs
the loop on a background thread, which is how ``GenerationServer`` gets
concurrency.

Covered here: prefill into a slot and chunked decode, the exact-prompt
prefill cache, chunked prefill, ``max_queue`` and ``admission_timeout``,
logprobs and streaming callbacks, and image requests through a
``PaliGemmaEngine``, ``Gemma3MMEngine``, ``Qwen2VLMMEngine`` or
``LlavaNextMMEngine`` (``mm_engine``): such a request prefills through the
engine's own image prefill and then decodes in the same slot batch as the
text requests, from the position its prefill ends at (mrope's for Qwen2-VL)
while its K/V rows follow the prompt's. An engine that decodes with
cross-attention (``MllamaMMEngine``, ``cross_decode``) gets per-slot cross
pools of ``cross_max_images`` images (scheduler.py:157-172): an image
request's prefill yields its images' packed cross K/V, installed in its
slot, and every decode step runs the engine's cross blocks over the pools;
text slots run them under a uniform mask and keep their input, so their
streams equal the text engine's.

The dense per-slot caches ``[B, max_seq_len, Hkv, D]`` are made by
``_init_kv``, which the paged batcher replaces with its page pools, so a
paged batcher never allocates them. The loop thread enters
``torch.inference_mode`` itself (it is thread-local), so no decode step keeps
an autograd graph alive.

Every scheduling point starts with an *admission record*
(:meth:`ContinuousBatcher._sync`): the requests submitted since the last one
(prompt ids, sampling settings, eos, logprobs, an image request's pixels),
the queued requests ``admission_timeout`` expired by the
clock of the rank that built it, the constrained forwards
(:meth:`ContinuousBatcher.submit_logits`) and whether to stop. The batcher
applies it, then admits and decodes from its own state alone.

Over an engine's mesh (scheduler.py:178-231; JAX runs one controller over
every device) the mesh's first rank is the leader: its submits fill the
records, and it broadcasts each one to the other ranks
(``parallel.broadcast_object``), which run :meth:`ContinuousBatcher.follow`
in place of :meth:`ContinuousBatcher.serve`. Every rank applies the same
records and runs the same ``_admit`` / ``_step_chunk``, so admissions, page
grants, preemptions and counters are the same everywhere with no other
traffic: each is a pure function of the record sequence, the sampler's noise
a function of (seed, step), and nothing past the record reads a clock.
Futures and ``on_token`` callbacks resolve on the leader (a rank that
submitted the same calls itself, as ``generate`` on every rank does, gets its
own resolved too). At one rank the leader builds and applies the same
records without the broadcast.

A prefill (one prompt) runs on every data rank, tensor-parallel over
``model``: its logits keep the schedulers in lockstep. When the ``data``
size divides ``batch_slots``, each data rank decodes its own slots (``_sl``)
and a step ends with every rank holding the same next tokens (an
all-gather). The dense caches and Mllama's cross pools then hold only the
rank's ``batch_slots / data`` slots, as JAX shards them (scheduler.py:
216-233): a prompt's rows and a decode row are written by the rank that owns
the slot. The paged pools hold every slot on every data rank (JAX splits
only their heads), so prefix pages and preemption need no traffic.
"""

from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
import time
import traceback
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from multimodal_colpali_tpu_torch.generation.engine import (
    LOGPROB_K, GemmaDecodeEngine, _step_logprobs, attn_scale, layer_stack, left_pad,
    sample_per_slot)
from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.parallel.mesh import batch_sharding, broadcast_object


class AdmissionQueueFull(RuntimeError):
    """Raised into a submitted future when the admission queue is at its
    bound (``max_queue``); ``GenerationServer`` answers it with HTTP 429."""


@dataclasses.dataclass
class _Request:
    prompt: List[int]
    max_new_tokens: int
    temperature: float
    seed: int
    future: Optional[Future]         # None on a rank that did not submit it
    eos_id: int = -1
    t_submit: float = 0.0           # monotonic clock at submit()
    tokens: List[int] = dataclasses.field(default_factory=list)
    on_token: Optional[Any] = None   # streaming callback(token_id)
    streamed: int = 0                # tokens already delivered to on_token
    top_p: float = 1.0
    top_k: int = 0
    want_logprobs: int = 0           # 0 = off; else keep the top-N alternatives
    pixel_values: Optional[torch.Tensor] = None   # [N, H, W, 3]: an image request
    pix_digest: Optional[str] = None               # _pixel_digest(pixel_values)
    lps: List[float] = dataclasses.field(default_factory=list)
    tops: List[Any] = dataclasses.field(default_factory=list)
    rid: int = -1                    # its place in the record sequence


@dataclasses.dataclass
class _Forward:
    """A constrained forward: next-token logits of one prompt (with its
    pixels), run by every rank at one scheduling point."""

    prompt: List[int]
    future: Optional[Future]
    pixel_values: Any = None


# the fields of a request that travel in a record
_WIRE = ("rid", "prompt", "max_new_tokens", "temperature", "seed", "eos_id", "top_p", "top_k",
         "want_logprobs", "pixel_values", "pix_digest")


def _settle(fut: Optional[Future], result: Any = None,
            exc: Optional[BaseException] = None) -> None:
    """Resolve ``fut`` where this rank holds it (None: another rank's request)."""
    if fut is None or fut.done():
        return
    if exc is not None:
        fut.set_exception(exc)
    else:
        fut.set_result(result)


def _host(x: Any) -> Any:
    """A tensor as a host numpy array (what a record may carry); else ``x``."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _pixel_digest(pix: torch.Tensor) -> str:
    """SHA-1 of an image request's pixels (dtype, shape and bytes): its
    key in the prefill cache and in the paged batcher's page chains."""
    host = pix.detach().contiguous().cpu()
    h = hashlib.sha1(f"{host.dtype} {tuple(host.shape)}".encode())
    h.update(host.reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


class ContinuousBatcher:
    """Slot-based continuous batching over a ``GemmaDecodeEngine``."""

    def __init__(self, engine: GemmaDecodeEngine, batch_slots: int = 4,
                 max_seq_len: int = 512, chunk: int = 8, prompt_bucket: int = 16,
                 eos_id: int = -1, pad_id: int = 0, prefill_cache_entries: int = 8,
                 mm_engine: Any = None, prefill_chunk: int = 0, max_queue: int = 0,
                 admission_timeout: float = 0.0, cross_max_images: int = 1):
        """``max_queue > 0`` bounds the admission queue (a submit past it
        fails with ``AdmissionQueueFull``); ``admission_timeout > 0`` fails a
        request still queued after that many seconds with ``TimeoutError``.
        ``prefill_chunk > 0`` prefills text prompts longer than that in
        segments, one per scheduling point (chunked prefill).

        ``mm_engine`` (an image engine whose ``lm`` is ``engine``) takes image
        requests (``submit(pixel_values=)``); an engine that says it is not
        batcher-compatible is refused (scheduler.py:113-119). A cross-decode
        engine's pools hold ``cross_max_images`` images a slot; a request
        with more is refused at submit."""
        if mm_engine is not None and not getattr(mm_engine, "batcher_compatible", True):
            raise ValueError(f"{type(mm_engine).__name__} is not batcher-compatible; serve its "
                             f"image requests through the engine's own generate")
        self._cross_mode = bool(getattr(mm_engine, "cross_decode", False))
        self.mesh = getattr(engine, "mesh", None)
        self._multi_rank = self.mesh is not None and self.mesh.devices.size > 1
        self.leader = getattr(self.mesh, "is_leader", True)
        self._sl = slice(None)            # the slots this rank decodes and caches
        self._lo, self._b_local = 0, batch_slots
        if self.mesh is not None:
            dp = self.mesh.size("data")
            if dp > 1 and batch_slots % dp == 0:
                lo, hi = batch_sharding(self.mesh).bounds(batch_slots)
                self._sl, self._lo, self._b_local = slice(lo, hi), lo, hi - lo
        self.engine = engine
        self.mm_engine = mm_engine
        self.cfg = engine.cfg
        self.device = engine.device
        self.B = batch_slots
        self.T = max_seq_len
        self.chunk = chunk
        self.bucket = prompt_bucket
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.prefill_chunk = int(prefill_chunk)
        self.max_queue = int(max_queue)
        self.admission_timeout = float(admission_timeout)
        self.expired = 0
        self.rejected = 0                 # the leader's: a refused submit enters no record
        self.admissions = 0
        self.records = 0
        self.constrained_forwards = 0
        self._chunked: Optional[Dict[str, Any]] = None
        self.chunked_prefill_segments = 0
        # host-clock counters: decode chunks (each ends in a device sync) and
        # time to first token per fresh request (submit -> first token synced)
        self.decode_s = 0.0
        self.decode_steps = 0
        self.decode_tokens = 0
        self.ttft_s: List[float] = []

        b, dev = self.B, self.device
        self._init_kv()
        self._tok = torch.zeros(b, dtype=torch.int32, device=dev)
        self._pos = torch.zeros(b, dtype=torch.int64, device=dev)
        self._start = torch.zeros(b, dtype=torch.int64, device=dev)  # first valid cache row
        self._end = torch.zeros(b, dtype=torch.int64, device=dev)    # next write index
        self._temp = torch.zeros(b, dtype=torch.float32, device=dev)
        self._remaining = torch.zeros(b, dtype=torch.int64, device=dev)
        self._seed = torch.zeros(b, dtype=torch.int64, device=dev)
        self._eos = torch.full((b,), eos_id, dtype=torch.int64, device=dev)
        self._gen_step = torch.zeros(b, dtype=torch.int64, device=dev)
        self._top_p = torch.ones(b, dtype=torch.float32, device=dev)
        self._top_k = torch.zeros(b, dtype=torch.int64, device=dev)
        if self._cross_mode:
            # per-slot pools of the packed real-tile cross K/V, written at
            # install; a slot's rows in use on the host (0: a text slot)
            c = self.cfg
            self._cross_skv = int(cross_max_images) * mm_engine.packed_cross_tokens_per_image
            pool = (len(mm_engine.cfg.cross_attention_layers), self._b_local, self._cross_skv,
                    c.num_key_value_heads, c.head_dim)
            self._cross_k = torch.zeros(pool, dtype=engine.dtype, device=dev)
            self._cross_v = torch.zeros(pool, dtype=engine.dtype, device=dev)
            self._cross_len = [0] * b

        self._slots: List[Optional[_Request]] = [None] * self.B
        # submits not yet in a record; the requests the records brought, in order
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._pending: "deque[_Request]" = deque()
        self._forwards: "queue.Queue[_Forward]" = queue.Queue()
        self._next_rid = 0
        self._stopped = False
        self._wake = threading.Event()
        # preempted requests and admissions deferred for lack of capacity
        self._readmit: List[_Request] = []
        # exact-prompt prefill cache (LRU): (k, v, logits, last_pos) per prompt
        self._prefill_cache: "OrderedDict[Any, Any]" = OrderedDict()
        self._prefill_cache_entries = prefill_cache_entries
        self.prefill_cache_hits = 0
        self._lock = threading.Lock()
        self._serving = False
        self._thread: Optional[threading.Thread] = None

    def _init_kv(self) -> None:
        """The dense per-slot caches of this rank's slots, one ``[B / data,
        T, Hkv, D]`` pair per layer (``[B, ...]`` where ``data`` does not
        divide ``B``)."""
        c = self.cfg
        shape = (self._b_local, self.T, c.num_key_value_heads, c.head_dim)
        self._kc = [torch.zeros(shape, dtype=self.engine.dtype, device=self.device)
                    for _ in range(c.num_hidden_layers)]
        self._vc = [torch.zeros(shape, dtype=self.engine.dtype, device=self.device)
                    for _ in range(c.num_hidden_layers)]

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _own(self, slot: int) -> Optional[int]:
        """``slot``'s row in this rank's dense caches and cross pools, or
        None where another data rank holds it."""
        i = slot - self._lo
        return i if 0 <= i < self._b_local else None

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every slot's rows of a per-slot result of this rank's slots."""
        return t if self._sl == slice(None) else batch_sharding(self.mesh).gather(t)

    # -- prefill ----------------------------------------------------------------

    def _prefill(self, tokens: Sequence[int], s: int):
        """One prompt left-padded to ``s`` -> (k, v rows ``[1, s]`` per layer,
        next-token logits ``[V]``, last position)."""
        eng = self.engine
        ids, mask = (self._tensor(a) for a in left_pad([tokens], s, self.pad_id))
        kc, vc = eng._caches(1, s)
        positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
        hidden, (k, v) = eng._chunk(eng.params, eng._embed(eng.params, ids), positions,
                                    kc, vc, 0, mask.bool())
        return k, v, eng._logits(eng.params, hidden[:, -1])[0], int(positions[0, -1])

    def _mm_prefill(self, tokens: Sequence[int], s: int, pixel_values: torch.Tensor):
        """An image prompt left-padded to ``s`` through the engine's prefill
        (scheduler.py:255-306): PaliGemma's bidirectional prefix at 1-indexed
        positions, Gemma-3's causal prompt with bidirectional image spans at
        0-indexed ones, Qwen2-VL's and LLaVA-NeXT's causal prompts at mrope's
        or plain positions; the last position is the engine's."""
        mm = self.mm_engine
        ids, mask = (self._tensor(a) for a in left_pad([tokens], s, self.pad_id))
        kc, vc = mm.lm._caches(1, s)
        pix = mm._pixels(pixel_values)[None]
        if self._cross_mode:
            # Mllama (scheduler.py:268-276): the prefill also yields the
            # packed cross K/V the slot's pools take at install
            hidden, (k, v), positions, ckv = mm.prefill_cross(ids, mask, pix, kc, vc)
            return (k, v, mm.lm._logits(mm.lm.params, hidden[:, -1])[0],
                    int(positions[0, -1]), mm.packed_cross_kv(ckv, pix.shape[1]))
        hidden, (k, v), positions = mm.prefill(ids, mask, pix, kc, vc)
        return k, v, mm.lm._logits(mm.lm.params, hidden[:, -1])[0], int(positions[0, -1])

    def _full_prefill(self, req: _Request, prompt_eff, s: int):
        """Whole-prompt prefill (scheduler.py:537-559). A resumed image
        request extends its prompt causally instead (:meth:`_mm_resume_prefill`),
        except a cross-decode one: its prefill is causal at plain positions and
        a generated token attends every image there as in decode, so prompt
        and generated tokens re-prefill as one (scheduler.py:547-560)."""
        if req.pixel_values is not None and req.tokens and not self._cross_mode:
            return self._mm_resume_prefill(req, s)
        return self._prefill_raw(prompt_eff, s, req.pixel_values, req.pix_digest)

    def _prefill_raw(self, tokens, s, pixel_values=None, pix_digest=None):
        """Whole-prompt prefill through the exact-prompt LRU cache, keyed by
        the pixels' digest too."""
        key = (s, tuple(tokens), pix_digest)
        if key in self._prefill_cache:
            self._prefill_cache.move_to_end(key)
            self.prefill_cache_hits += 1
            return self._prefill_cache[key]
        out = (self._prefill(tokens, s) if pixel_values is None
               else self._mm_prefill(tokens, s, pixel_values))
        if self._prefill_cache_entries > 0:
            self._prefill_cache[key] = out
            while len(self._prefill_cache) > self._prefill_cache_entries:
                self._prefill_cache.popitem(last=False)
        return out

    def _mm_resume_prefill(self, req: _Request, s: int):
        """A preempted image request's prompt + generated tokens
        (scheduler.py:594-667): the prompt re-prefills through the image
        prefill (an LRU hit, usually), then the generated tokens extend it
        causally at their decode positions, as the uninterrupted decode
        computed them: after the prompt's last position as its prefill gave
        it (``n_p`` for PaliGemma, ``n_p - 1`` for Gemma-3 and LLaVA-NeXT,
        mrope's for Qwen2-VL, smaller than ``n_p - 1``; JAX's
        scheduler.py:613 takes ``n_p - 1`` for every causal engine). The
        generated rows follow the prompt's directly, so slot distance stays
        token distance (Gemma-3's sliding window counts slots). Returns the
        rows left-padded to ``s`` over the whole sequence."""
        prompt, gen = req.prompt, list(req.tokens)
        n_p, n_gen = len(prompt), len(gen)
        s1 = max(((n_p + self.bucket - 1) // self.bucket) * self.bucket, self.bucket)
        k1, v1, _, last = self._prefill_raw(prompt, s1, req.pixel_values, req.pix_digest)
        s2 = max(((n_gen + self.bucket - 1) // self.bucket) * self.bucket, self.bucket)
        lm, c, dev = self.mm_engine.lm, self.cfg, self.device
        shape = (1, n_p + s2, c.num_key_value_heads, c.head_dim)
        kc, vc = [], []
        for a, b in zip(k1, v1):
            kc.append(torch.zeros(shape, dtype=lm.dtype, device=dev))
            vc.append(torch.zeros(shape, dtype=lm.dtype, device=dev))
            kc[-1][:, :n_p] = a[:, s1 - n_p:]
            vc[-1][:, :n_p] = b[:, s1 - n_p:]
        mask2 = torch.zeros((1, s2), dtype=torch.int64, device=dev)
        mask2[0, :n_gen] = 1
        ids2 = torch.full((1, s2), self.pad_id, dtype=torch.int64, device=dev)
        ids2[0, :n_gen] = self._tensor(gen, torch.int64)
        positions = last + torch.cumsum(mask2, dim=1)
        kv_valid = torch.cat([torch.ones((1, n_p), dtype=torch.bool, device=dev),
                              mask2.bool()], dim=1)
        hidden, (k2, v2) = lm._chunk(lm.params, lm._embed(lm.params, ids2), positions, kc, vc,
                                     n_p, kv_valid)
        n_eff = n_p + n_gen
        outk, outv = [], []
        for a2, b2, a1, b1 in zip(k2, v2, k1, v1):
            for out, new, old in ((outk, a2, a1), (outv, b2, b1)):
                rows = torch.zeros((1, s) + shape[2:], dtype=lm.dtype, device=dev)
                rows[:, s - n_eff: s - n_gen] = old[:, s1 - n_p:]
                rows[:, s - n_gen:] = new[:, n_p: n_p + n_gen]
                out.append(rows)
        return (tuple(outk), tuple(outv), lm._logits(lm.params, hidden[:, n_gen - 1])[0],
                int(positions[0, n_gen - 1]))

    # -- decode -----------------------------------------------------------------

    def _cross_hooks(self):
        """The cross blocks of a decode or verify step over the slots' pools,
        cut to the most rows a slot uses (masked rows weigh nothing), or None
        when no slot holds an image: every text slot keeps its input then."""
        if not self._cross_mode or not any(self._cross_len):
            return None
        n = max(self._cross_len)
        clen = self._tensor(self._cross_len[self._sl], torch.int64)
        return self.mm_engine.pool_hooks(self._cross_k[:, :, :n], self._cross_v[:, :, :n], clen)

    def _install_cross(self, slot: int, cross) -> None:
        """An image request's packed cross K/V ``[n_cross, 1, R, Hkv, D]``
        into its slot's pools (scheduler.py:701-709); None: a text slot."""
        if not self._cross_mode:
            return
        if cross is None:
            self._cross_len[slot] = 0
            return
        ks, vs = cross
        rows, mine = ks.shape[2], self._own(slot)
        if mine is not None:
            self._cross_k[:, mine, :rows] = ks[:, 0]
            self._cross_v[:, mine, :rows] = vs[:, 0]
        self._cross_len[slot] = rows

    def _reset_cross(self, slot: Optional[int] = None) -> None:
        if self._cross_mode:
            for i in (range(self.B) if slot is None else [slot]):
                self._cross_len[i] = 0

    def _decode_step(self, p, kv_write, attend):
        """One decode token for every slot; the caller's ``kv_write`` and
        ``attend`` decide where K/V live (for this rank's slots ``_sl``).
        Returns (token, logprob, top ids, top logprobs) of every slot and
        advances the per-slot state."""
        eng, c, sl = self.engine, self.cfg, self._sl
        x = eng._embed(p, self._tok[sl][:, None])
        b = x.shape[0]
        active = self._remaining > 0
        xx, _ = layer_stack(p, c, x, self._pos[sl][:, None], kv_write, attend,
                            interleave=self._cross_hooks())
        logits = eng._logits(p, xx[:, 0])
        with_filter, with_logprobs = self._flags
        nxt = sample_per_slot(logits, self._seed[sl], self._gen_step[sl], self._temp[sl],
                              self._top_p[sl], self._top_k[sl], use_filter=with_filter)
        nxt = torch.where(active[sl], nxt, torch.full_like(nxt, self.pad_id))
        if with_logprobs:
            lp, tid, tlp = _step_logprobs(logits, nxt)
        else:
            lp = torch.zeros(b, dtype=torch.float32, device=self.device)
            tid = torch.zeros((b, 1), dtype=torch.int32, device=self.device)
            tlp = torch.zeros((b, 1), dtype=torch.float32, device=self.device)
        nxt, lp, tid, tlp = (self._gather(t) for t in (nxt, lp, tid, tlp))
        self._advance(active, nxt)
        return nxt, lp, tid, tlp

    def _advance(self, active, nxt) -> None:
        one = active.long()
        self._end = self._end + one
        self._pos = self._pos + one
        self._gen_step = self._gen_step + one
        self._remaining = self._remaining - one
        self._remaining = torch.where(nxt.long() == self._eos,
                                      torch.zeros_like(self._remaining), self._remaining)
        self._tok = nxt

    def _dense_step(self, p):
        """``_decode_step`` over the dense per-slot caches (scheduler.py:328-409),
        this rank's rows of them."""
        c, t, sl = self.cfg, self.T, self._sl
        rows = torch.arange(self._b_local, device=self.device)
        cols = torch.arange(t, device=self.device)
        start, end = self._start[sl], self._end[sl]
        mask = ((cols[None, :] >= start[:, None]) & (cols[None, :] <= end[:, None]))[:, None,
                                                                                    None, :]
        types = c.layer_types_resolved if getattr(c, "is_gemma3", False) else None
        if types is not None:
            sl_mask = mask & (cols[None, :] > (end - c.sliding_window)[:, None])[:, None, None, :]
        sc = attn_scale(c)

        def kv_write(i, k, v):
            self._kc[i][rows, end] = k[:, 0]
            self._vc[i][rows, end] = v[:, 0]
            return self._kc[i], self._vc[i]

        def attend(i, q, kc, vc):
            m = sl_mask if types is not None and types[i] == "sliding_attention" else mask
            return L.attention(q, kc, vc, mask=m, scale=sc)

        return self._decode_step(p, kv_write, attend)

    def _one_step(self, p):
        return self._dense_step(p)

    # -- scheduling -------------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               temperature: float = 0.0, seed: int = 0, eos_id: Optional[int] = None,
               pixel_values: Optional[Any] = None, on_token: Optional[Any] = None,
               top_p: float = 1.0, top_k: int = 0, logprobs: int = 0) -> Future:
        """Queue a request for the next record. ``on_token(token_id)``
        streams each generated token as the scheduler syncs it (never eos or
        anything past it); ``logprobs=N`` makes the future resolve to
        ``(tokens, logprobs, top_lists)`` and the stream carry ``(token,
        logprob, top)`` triples. ``max_queue`` bounds the requests still
        waiting for a slot: those not yet in a record and those a record
        brought (``_pending``)."""
        fut: Future = Future()
        if self.max_queue > 0 and self._queue.qsize() + len(self._pending) >= self.max_queue:
            self.rejected += 1
            fut.set_exception(AdmissionQueueFull(
                f"admission queue at its bound ({self.max_queue}); retry with backoff"))
            return fut
        s = max(((len(prompt) + self.bucket - 1) // self.bucket) * self.bucket, self.bucket)
        if s >= self.T:
            fut.set_exception(ValueError(
                f"prompt of {len(prompt)} tokens buckets to {s} >= max_seq_len {self.T}"))
            return fut
        if pixel_values is not None:
            if self.mm_engine is None:
                fut.set_exception(ValueError("multimodal request but no mm_engine configured"))
                return fut
            # one image [H, W, 3] or a stack [N, H, W, 3] of N context images;
            # the prompt carries N * num_patches image tokens. The pixels stay
            # where they are (a card tensor is not copied back and forth); the
            # digest is taken once, here, off the scheduling loop.
            pixel_values = self._stacked(pixel_values)
            n_img = pixel_values.shape[0]
            if self._cross_mode:
                need = n_img * self.mm_engine.packed_cross_tokens_per_image
                if need > self._cross_skv:
                    fut.set_exception(ValueError(
                        f"{n_img} images need {need} cross-KV rows > pool "
                        f"{self._cross_skv}; raise cross_max_images"))
                    return fut
        self._queue.put(_Request(
            list(prompt), max_new_tokens, float(temperature), seed, fut,
            eos_id=self.eos_id if eos_id is None else eos_id, t_submit=time.monotonic(),
            on_token=on_token, top_p=float(top_p), top_k=int(top_k),
            want_logprobs=max(0, min(int(logprobs), LOGPROB_K)), pixel_values=pixel_values,
            pix_digest=None if pixel_values is None else _pixel_digest(pixel_values)))
        self._wake.set()
        return fut

    def _stacked(self, pixel_values) -> torch.Tensor:
        """Pixels as a tensor stack of the request's images ``[N, ...]``."""
        if not isinstance(pixel_values, torch.Tensor):
            pixel_values = torch.from_numpy(np.asarray(pixel_values))
        if pixel_values.dim() == getattr(self.mm_engine, "image_rank", 3):
            pixel_values = pixel_values[None]
        return pixel_values

    def submit_logits(self, prompt: Sequence[int], pixel_values: Optional[Any] = None) -> Future:
        """A constrained forward: the future resolves to the float32
        next-token logits ``[V]`` of ``prompt`` (through ``mm_engine`` with
        the request's pixels). It runs at the next
        scheduling point, one forward at a time, on every rank of the mesh
        (the text engine's ``next_token_logits`` or the image engine's), and
        the leader's logits resolve it."""
        fut: Future = Future()
        if pixel_values is not None and self.mm_engine is None:
            fut.set_exception(ValueError("multimodal request but no mm_engine configured"))
            return fut
        self._forwards.put(_Forward(
            list(prompt), fut, None if pixel_values is None else self._stacked(pixel_values)))
        self._wake.set()
        return fut

    @property
    def supports_multimodal(self) -> bool:
        return self.mm_engine is not None

    def _pop_live(self) -> Optional[_Request]:
        """Next request the records brought (expired ones left with the
        record that expired them)."""
        return self._pending.popleft() if self._pending else None

    # -- admission records --------------------------------------------------------

    @staticmethod
    def _drained(q: "queue.Queue") -> list:
        out = []
        while True:
            try:
                out.append(q.get_nowait())
            except queue.Empty:
                return out

    def _record(self, stop: bool) -> Dict[str, Any]:
        """The leader's record of this scheduling point (scheduler.py:
        515-531): the submits since the last one (numbered in order), the
        queued requests ``admission_timeout`` expired by this clock, the
        constrained forwards, and whether to stop."""
        if stop:
            return {"new": [], "expired": [], "forwards": [], "stop": True}
        new = self._drained(self._queue)
        for req in new:
            req.rid, self._next_rid = self._next_rid, self._next_rid + 1
        expired = []
        if self.admission_timeout > 0:
            now = time.monotonic()
            expired = [r.rid for r in (*self._pending, *new)
                       if not r.tokens and now - r.t_submit > self.admission_timeout]
        return {"new": new, "expired": expired, "forwards": self._drained(self._forwards),
                "stop": False}

    def _wire(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        """A record as the other ranks receive it: plain values, pixels on the host."""
        return dict(rec, new=[{f: _host(getattr(r, f)) for f in _WIRE} for r in rec["new"]],
                    forwards=[(f.prompt, _host(f.pixel_values)) for f in rec["forwards"]])

    def _unwire(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        """A received record as requests of this rank. A rank that submitted
        the same calls itself (every rank driving the batcher alike) pairs
        its own submits with the record's, in order, so their futures
        resolve here too."""
        new = []
        for spec in rec["new"]:
            pix = spec.pop("pixel_values")
            req = _Request(future=None, t_submit=time.monotonic(), **spec,
                           pixel_values=None if pix is None else torch.from_numpy(pix))
            if not self._queue.empty():
                mine = self._queue.get_nowait()
                if mine.prompt != req.prompt:
                    raise RuntimeError("this rank's submits differ from the leader's")
                req.future, req.on_token = mine.future, mine.on_token
            new.append(req)
        forwards = [_Forward(prompt, None, None if pix is None else torch.from_numpy(pix))
                    for prompt, pix in rec["forwards"]]
        return dict(rec, new=new, forwards=forwards)

    def _sync(self, stop: bool = False) -> bool:
        """The scheduling point: the leader builds the record and broadcasts
        it over the mesh (at one rank it only builds it), every rank applies
        it. False when the record stops the loop."""
        rec = self._record(stop) if self.leader else None
        if self._multi_rank:
            got = broadcast_object(self.mesh, self._wire(rec) if self.leader else None)
            if not self.leader:
                rec = self._unwire(got)
        self.records += 1
        if rec["stop"]:
            self._stopped = True
            return False
        self._pending.extend(rec["new"])
        if rec["expired"]:
            gone = set(rec["expired"])
            for req in [r for r in self._pending if r.rid in gone]:
                self._pending.remove(req)
                self.expired += 1
                _settle(req.future, exc=TimeoutError(
                    f"request waited > {self.admission_timeout:.1f}s for admission"))
        for fwd in rec["forwards"]:
            self._run_forward(fwd)
        return True

    def _run_forward(self, fwd: _Forward) -> None:
        """One constrained forward (server.py:167-203) on this rank; its
        failure fails its future alone."""
        self.constrained_forwards += 1
        try:
            if fwd.pixel_values is None:
                logits = self.engine.next_token_logits([fwd.prompt])[0]
            else:
                logits = self.mm_engine.next_token_logits([fwd.prompt],
                                                          fwd.pixel_values[None])[0]
        except Exception as exc:  # noqa: BLE001 - the request's failure, not the loop's
            _settle(fwd.future, exc=exc)
            return
        _settle(fwd.future, logits)

    # Hooks the paged batcher overrides ------------------------------------------

    def _prefix_prefill(self, prompt_eff, ctx, mm):
        """Prefill only the prompt tail against cached prefix KV; None runs
        the whole-prompt prefill. ``ctx`` is an image request's pixel digest."""
        return None

    def _can_admit(self, s: int, n_prompt: int, budget: int, tokens=None, mm: bool = False,
                   ctx=None) -> bool:
        return True

    def _slot_capacity(self, s: int) -> int:
        """Most tokens a slot can hold after an ``s``-token prompt."""
        return self.T - s

    def _install_slot(self, slot: int, s: int, n_prompt: int, k, v, tokens=None, ctx=None,
                      hint=None) -> None:
        """Copy prefill K/V rows (left-padded to ``s``) into the slot, on the
        rank whose dense caches hold it."""
        mine = self._own(slot)
        if mine is not None:
            for i in range(self.cfg.num_hidden_layers):
                self._kc[i][mine, :s] = k[i][0]
                self._vc[i][mine, :s] = v[i][0]
        self._start[slot] = s - n_prompt
        self._end[slot] = s

    def _advance_chunked(self) -> None:
        """Run one segment of the chunked prefill in flight
        (scheduler.py:711-756): segments sit at their final cache rows and
        attend causally to the segments before them, so the K/V and the
        final logits equal the whole-prompt prefill's."""
        st = self._chunked
        if st is None or st["out"] is not None:
            return
        eng = self.engine
        s, n, toks = st["s"], st["n"], st["tokens"]
        if st["kv"] is None:
            st["kv"] = eng._caches(1, s)
        start = st["j"] * self.prefill_chunk
        seg = toks[start:start + self.prefill_chunk]
        seg_len = len(seg)
        row0 = s - n + start
        first_row = s - n
        cols = torch.arange(s, device=self.device)
        kv_valid = ((cols >= first_row) & (cols < row0 + seg_len))[None]
        positions = (row0 - first_row) + torch.arange(seg_len, device=self.device)[None]
        kc, vc = st["kv"]
        hidden, (k, v) = eng._chunk(eng.params, eng._embed(eng.params, self._tensor([seg])),
                                    positions, kc, vc, row0, kv_valid)
        logits = eng._logits(eng.params, hidden[:, -1])[0]
        st["kv"] = (list(k), list(v))
        st["j"] += 1
        self.chunked_prefill_segments += 1
        if start + seg_len >= n:
            st["out"] = (k, v, logits, n - 1)   # positions are 0-indexed

    def _admit(self) -> None:
        """Fill free slots, readmissions first, then the queue
        (scheduler.py:758-843), after the scheduling point's record. A
        readmitted request re-prefills its prompt with the tokens generated
        so far and samples on from its own step."""
        if not self._sync():
            return
        self._advance_chunked()
        for slot in range(self.B):
            if self._slots[slot] is not None:
                continue
            if self._chunked is not None and self._chunked["out"] is not None:
                st, self._chunked = self._chunked, None
                req = st["req"]
                k, v, logits, last_pos = st["out"]
                if not self._can_admit(st["s"], st["n"], req.max_new_tokens - len(req.tokens),
                                       tokens=st["tokens"]):
                    self._readmit.insert(0, req)
                    continue
                self._finish_admission(slot, req, st["s"], st["tokens"], k, v, logits,
                                       last_pos, None)
                continue
            if self._readmit:
                req = self._readmit.pop(0)
            else:
                req = self._pop_live()
                if req is None:
                    return
            prompt_eff = req.prompt + req.tokens
            s = max(((len(prompt_eff) + self.bucket - 1) // self.bucket) * self.bucket,
                    self.bucket)
            mm = req.pixel_values is not None
            if not self._can_admit(s, len(prompt_eff), req.max_new_tokens - len(req.tokens),
                                   tokens=prompt_eff, mm=mm, ctx=req.pix_digest):
                if not any(r is not None for r in self._slots):
                    _settle(req.future, exc=ValueError(
                        f"prompt of {len(prompt_eff)} tokens (+ decode budget) exceeds the "
                        f"KV capacity of an empty scheduler"))
                    continue
                self._readmit.insert(0, req)
                return
            hint = cross = None
            pre = self._prefix_prefill(prompt_eff, req.pix_digest, mm)
            if pre is not None:
                k, v, logits, last_pos, hint = pre
            elif (not mm and self.prefill_chunk and len(prompt_eff) > self.prefill_chunk
                  and self._chunked is None):
                self._chunked = {"req": req, "s": s, "n": len(prompt_eff),
                                 "tokens": prompt_eff, "j": 0, "kv": None, "out": None}
                self._advance_chunked()
                continue   # the slot stays free for other admissions
            else:
                out = self._full_prefill(req, prompt_eff, s)
                k, v, logits, last_pos = out[:4]
                if len(out) > 4:          # a cross-decode engine's packed cross K/V
                    cross = out[4]
            self._finish_admission(slot, req, s, prompt_eff, k, v, logits, last_pos, hint,
                                   req.pix_digest, cross=cross)

    def _finish_admission(self, slot, req, s, prompt_eff, k, v, logits, last_pos,
                          hint, ctx=None, cross=None) -> None:
        """Sample the first token from the prefill logits and install the
        request; a resumed request samples at its own step index."""
        n0 = len(req.tokens)
        one = lambda val, dt: self._tensor([val], dt)  # noqa: E731
        if req.temperature > 0:
            tok0 = int(sample_per_slot(
                logits[None], one(req.seed, torch.int64), one(n0, torch.int64),
                one(req.temperature, torch.float32), one(req.top_p, torch.float32),
                one(req.top_k, torch.int64),
                use_filter=req.top_p < 1.0 or req.top_k > 0)[0])
        else:
            tok0 = int(torch.argmax(logits))
        self.admissions += 1
        if n0 == 0:
            self.ttft_s.append(time.monotonic() - req.t_submit)
        req.tokens.append(tok0)
        if req.want_logprobs:
            lp0, tid0, tlp0 = _step_logprobs(logits[None], one(tok0, torch.int64))
            req.lps.append(float(lp0[0]))
            n = req.want_logprobs
            req.tops.append(list(zip(tid0[0, :n].tolist(), tlp0[0, :n].tolist())))
        self._emit_stream(req)   # the first token streams at prefill time
        self._slots[slot] = req
        budget = min(req.max_new_tokens - n0, self._slot_capacity(s))
        done0 = tok0 == req.eos_id or budget <= 1
        self._install_slot(slot, s, len(prompt_eff), k, v, tokens=prompt_eff, ctx=ctx,
                           hint=hint)
        self._install_cross(slot, cross)
        self._tok[slot] = tok0
        self._pos[slot] = int(last_pos) + 1
        self._temp[slot] = req.temperature
        self._seed[slot] = req.seed
        self._eos[slot] = req.eos_id
        self._top_p[slot] = req.top_p
        self._top_k[slot] = req.top_k
        self._gen_step[slot] = n0 + 1
        self._remaining[slot] = 0 if done0 else budget - 1
        if done0:
            self._finish(slot)

    def _finish(self, slot: int) -> None:
        req = self._slots[slot]
        self._slots[slot] = None
        self._reset_cross(slot)
        toks = req.tokens
        if req.eos_id in toks:
            toks = toks[: toks.index(req.eos_id)]
        _settle(req.future, (toks, req.lps[: len(toks)], req.tops[: len(toks)])
                if req.want_logprobs else toks)

    def _fail_all(self, exc: BaseException) -> None:
        """Fail every active, chunked, readmitted, pending and queued request
        and every queued constrained forward with ``exc``."""
        if self._chunked is not None:
            req = self._chunked["req"]
            self._chunked = None
            _settle(req.future, exc=exc)
        for slot, req in enumerate(self._slots):
            if req is not None:
                self._slots[slot] = None
                _settle(req.future, exc=exc)
        for req in (*self._readmit, *self._pending, *self._drained(self._queue),
                    *self._drained(self._forwards)):
            _settle(req.future, exc=exc)
        self._readmit.clear()
        self._pending.clear()
        self._remaining = torch.zeros_like(self._remaining)
        self._reset_cross()

    def _decode_flags(self):
        """(with_filter, with_logprobs) for the slots now active."""
        with_filter = any(r is not None and (r.top_p < 1.0 or r.top_k > 0) for r in self._slots)
        with_lp = any(r is not None and r.want_logprobs for r in self._slots)
        return with_filter, with_lp

    def _run_chunk(self) -> None:
        """``chunk`` decode steps, then the sync into per-request state."""
        t0 = time.perf_counter()
        self._flags = self._decode_flags()
        rem_before = self._remaining.cpu().numpy()
        ys = [self._one_step(self.engine.params) for _ in range(self.chunk)]
        self._account_chunk(tuple(torch.stack(y) for y in zip(*ys)), rem_before)
        self.decode_s += time.perf_counter() - t0
        self.decode_steps += self.chunk

    def _step_chunk(self) -> None:
        self._run_chunk()

    @staticmethod
    def _emit_stream(req: _Request) -> None:
        """Deliver not-yet-streamed tokens to ``req.on_token`` (eos and
        anything past it excluded); a failing callback cannot stop the loop."""
        if req.on_token is None:
            return
        toks = req.tokens
        if req.eos_id in toks:
            toks = toks[: toks.index(req.eos_id)]
        while req.streamed < len(toks):
            i = req.streamed
            req.streamed += 1
            try:
                if req.want_logprobs:
                    req.on_token((toks[i], req.lps[i], req.tops[i]))
                else:
                    req.on_token(toks[i])
            except Exception:  # noqa: BLE001
                pass

    def _account_chunk(self, ys, rem_before: np.ndarray) -> None:
        """Append each slot's real tokens of the chunk (and their logprob
        records), stream them and retire finished slots."""
        toks, lps, tids, tlps = (y.cpu().numpy() for y in ys)
        remaining = self._remaining.cpu().numpy()
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            for step in range(min(self.chunk, int(rem_before[slot]))):
                tok = int(toks[step, slot])
                req.tokens.append(tok)
                self.decode_tokens += 1
                if req.want_logprobs:
                    req.lps.append(float(lps[step, slot]))
                    n = req.want_logprobs
                    req.tops.append(list(zip(tids[step, slot, :n].tolist(),
                                             tlps[step, slot, :n].tolist())))
                if tok == req.eos_id:
                    break
            self._emit_stream(req)
            if (remaining[slot] <= 0 or len(req.tokens) >= req.max_new_tokens
                    or (req.tokens and req.tokens[-1] == req.eos_id)):
                self._finish(slot)

    def _busy(self) -> bool:
        return any(r is not None for r in self._slots)

    def _has_work(self) -> bool:
        return (not self._queue.empty() or not self._forwards.empty() or bool(self._pending)
                or bool(self._readmit) or self._chunked is not None or self._busy())

    @torch.inference_mode()
    def drain(self) -> None:
        """Run until every queued and active request completes. A failure
        fails every in-flight and queued future before it re-raises. Over a
        multi-rank mesh the other ranks run :meth:`follow`, or drain the
        same submits themselves."""
        with self._lock:
            try:
                while self._has_work():
                    self._admit()
                    if self._busy():
                        self._step_chunk()
            except Exception as exc:  # noqa: BLE001
                self._fail_all(exc)
                raise

    # -- background serving ------------------------------------------------------

    def serve(self) -> "ContinuousBatcher":
        """Run the scheduling loop on a background thread. On the mesh's
        leader (or without a mesh) it takes the submits; on every other rank
        it runs :meth:`follow`."""
        self._serving, self._stopped = True, False
        if not self.leader:
            self._thread = threading.Thread(target=self._follow_loop, daemon=True)
            self._thread.start()
            return self

        def loop():
            with torch.inference_mode():   # thread-local: enter it on this thread
                while True:
                    stopping = not self._serving
                    self._wake.clear()
                    busy = False
                    try:
                        with self._lock:
                            if stopping:      # the last record stops the followers
                                self._sync(stop=True)
                                return
                            self._admit()
                            busy = self._chunked is not None or self._busy()
                            if self._busy():
                                self._step_chunk()
                    except Exception as exc:  # noqa: BLE001 - must not kill serving
                        traceback.print_exc()
                        with self._lock:
                            self._fail_all(exc)
                        if stopping:
                            return
                    if not busy:
                        self._wake.wait(0.05)   # a submit wakes it

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def _follow_loop(self) -> None:
        with torch.inference_mode():
            while not self._stopped:
                try:
                    with self._lock:
                        self._admit()
                        if not self._stopped and self._busy():
                            self._step_chunk()
                except Exception as exc:  # noqa: BLE001 - the leader's loop goes on too
                    traceback.print_exc()
                    with self._lock:
                        self._fail_all(exc)

    def follow(self) -> "ContinuousBatcher":
        """A rank other than the leader: apply the leader's records and run
        the same admissions and decode steps until the leader stops (its
        ``shutdown``). Returns then; if :meth:`serve` already runs the loop
        on a thread, waits for that thread."""
        if self.leader:
            raise RuntimeError("follow() runs on the mesh's other ranks; the leader runs serve() "
                               "or drain()")
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        else:
            self._stopped = False
            self._follow_loop()
        return self

    def shutdown(self) -> None:
        """Stop the loop. The leader's last record stops the followers (also
        for a leader that drained without serving)."""
        self._serving = False
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=60)
        elif self._multi_rank and self.leader and not self._stopped:
            with self._lock:
                self._sync(stop=True)

    # GenerationServer protocol: generate through the batcher. ``pixel_values``
    # holds one image array (or None) a prompt, built with build_mm_prompt.
    def generate(self, prompts, max_new_tokens=64, temperature=0.0, eos_id=None,
                 pad_id=None, seed=0, pixel_values=None, top_p=1.0, top_k=0, **_):
        if pixel_values is None:
            pixel_values = [None] * len(prompts)
        futs = [self.submit(p, max_new_tokens, temperature, seed, eos_id=eos_id,
                            pixel_values=pix, top_p=top_p, top_k=top_k)
                for p, pix in zip(prompts, pixel_values)]
        if not self._serving:
            self.drain()
        return [f.result(timeout=600) for f in futs]
