"""Dense text embeddings: bge-base with the LangChain-style surface
(counterpart of ``multimodal_colpali_tpu/models/text_encoder.py``).

Stands where the reference has ``HuggingFaceEmbeddings`` (ingest) and
``FastEmbedEmbeddings`` (query time): one encoder, ``embed_documents`` /
``embed_query``, running on ``device``.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from multimodal_colpali_tpu_torch._device import resolve_device
from multimodal_colpali_tpu_torch.models import hf_import
from multimodal_colpali_tpu_torch.models.bert import BertEncoder
from multimodal_colpali_tpu_torch.models.configs import BertConfig
from multimodal_colpali_tpu_torch.models.convert import flax_shape, params_from_flax
from multimodal_colpali_tpu_torch.models.processing import SimpleTokenizer


class BgeEmbeddings:
    """CLS-pooled, L2-normalized sentence embeddings (bge convention)."""

    def __init__(
        self,
        model_name: str = "BAAI/bge-base-en-v1.5",
        cfg: Optional[BertConfig] = None,
        tokenizer: Optional[Any] = None,
        checkpoint_dir: Optional[str] = None,
        max_length: int = 512,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        device: Any = "cuda",
    ):
        self.model_name = model_name
        self.cfg = cfg or BertConfig.bge_base()
        self.max_length = min(max_length, self.cfg.max_position_embeddings)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or SimpleTokenizer(self.cfg.vocab_size, 0)

        ckpt = checkpoint_dir or _env_ckpt(model_name)
        if ckpt:
            params = hf_import.bert_params_from_hf(hf_import.load_state_dict(ckpt), self.cfg)
        else:
            warnings.warn(f"no local checkpoint for {model_name!r}; using random init",
                          stacklevel=2)
            params = _fast_bert_params(self.cfg, seed)
        # every leaf in ``dtype``, the embeddings and LayerNorms included
        # (text_encoder.py:54)
        self.model = BertEncoder(self.cfg, device=self.device, dtype=dtype)
        self.model.load_state_dict(params_from_flax(params, self.cfg))

    def _tokenize(self, texts: Sequence[str], bucket: int = 32):
        """``[CLS] ids[:max_length - 2] [SEP]`` a text (ids 101 / 102, mod the
        vocab), padded to a multiple of ``bucket`` capped at ``max_length``
        -> (input_ids, mask) int32 ``[B, S]``."""
        rows = []
        vocab = self.cfg.vocab_size
        for t in texts:
            try:
                ids = list(self.tokenizer.encode(t, add_special_tokens=False))
            except TypeError:
                ids = list(self.tokenizer.encode(t))
            rows.append([101 % vocab] + ids[: self.max_length - 2] + [102 % vocab])
        max_len = min(((max(len(r) for r in rows) + bucket - 1) // bucket) * bucket,
                      self.max_length)
        input_ids = np.zeros((len(rows), max_len), np.int32)
        mask = np.zeros((len(rows), max_len), np.int32)
        for i, r in enumerate(rows):
            r = r[:max_len]
            input_ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return input_ids, mask

    @torch.inference_mode()
    def embed_documents(self, texts: Sequence[str], batch_size: int = 64) -> List[List[float]]:
        out: List[List[float]] = []
        for s in range(0, len(texts), batch_size):
            ids, mask = self._tokenize(texts[s: s + batch_size])
            emb = self.model(torch.from_numpy(ids).to(self.device),
                             torch.from_numpy(mask).to(self.device))
            out.extend(emb.float().cpu().numpy().tolist())
        return out

    def embed_query(self, text: str) -> List[float]:
        return self.embed_documents([text])[0]


def _env_ckpt(model_name: str) -> Optional[str]:
    """A checkpoint directory under ``COLPALI_TPU_CKPT_DIR`` named after the
    model (``org--name``, then ``name``) holding weights, else None."""
    env = os.environ.get("COLPALI_TPU_CKPT_DIR")
    if not env:
        return None
    for cand in (os.path.join(env, model_name.replace("/", "--")),
                 os.path.join(env, os.path.basename(model_name))):
        if os.path.isdir(cand) and any(
                f.endswith((".safetensors", ".bin")) for f in os.listdir(cand)):
            return cand
    return None


def _fast_bert_params(cfg: BertConfig, seed: int) -> Dict[str, Any]:
    """JAX's random init, draw for draw (text_encoder.py:104-121): from
    ``np.random.default_rng(seed)``, one ``standard_normal(shape, float32) *
    fan_in ** -0.5`` per kernel or embedding (fan_in its first dim), zeros for
    biases, ones for LayerNorm weights. The draws run in the order in which
    ``jax.tree_util`` flattens the flax tree, dict keys sorted as strings
    (``layers_10`` before ``layers_2``, ``key`` before ``query``). -> the
    nested flax-named tree of float32 numpy arrays."""
    tree: Dict[str, Any] = {}
    for name, p in BertEncoder(cfg, device="meta").state_dict().items():
        parts = name.split(".")
        path = []
        i = 0
        while i < len(parts):
            if parts[i] == "layers":
                path.append(f"layers_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        if path[-1] == "weight" and p.dim() == 2:
            path[-1] = "kernel"
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = flax_shape(name, tuple(p.shape))
    rng = np.random.default_rng(seed)

    def fill(node: Dict[str, Any], parent: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key in sorted(node):
            val = node[key]
            if isinstance(val, dict):
                out[key] = fill(val, key)
            elif key == "bias":
                out[key] = np.zeros(val, np.float32)
            elif key == "weight":
                out[key] = (np.ones if "layernorm" in parent else np.zeros)(val).astype(
                    np.float32)
            else:
                fan_in = val[0] if len(val) >= 2 else val[-1]
                out[key] = rng.standard_normal(val, dtype=np.float32) * float(fan_in) ** -0.5
        return out

    return fill(tree, "")
