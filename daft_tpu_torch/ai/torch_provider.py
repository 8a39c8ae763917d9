"""The on-device AI provider: a BERT-family text encoder in PyTorch on the
engine's own device (counterpart of daft_tpu/ai/jax_provider.py), "torch" in
the provider registry.

The encoder (``Encoder``, an ``nn.Module`` run with
``torch.func.functional_call`` over the weights the device-UDF tier keeps
resident) is the reference's ``_encoder_fwd`` op for op: token and position
embeddings, LayerNorm (eps 1e-12, biased variance), per layer multi-head
attention with the bias ``(1 - mask) * -1e9`` added before the softmax,
LayerNorm, a tanh-approximated gelu feed-forward, LayerNorm; then the
masked mean over the tokens (divided by at least 1) and the L2 norm (of at
least 1e-9). Matmuls are PyTorch's float32 (no TF32: utils/torch_setup.py).

Weights come from a local transformers checkpoint (BERT / MiniLM layout,
``local_files_only``: no network) when one is on disk, else from a seed
(``TorchEncoderWeights.seeded``): the reference's draws from
``default_rng(_seed_of(name))`` in its order, so both packages hold the
same weights for one model name. Texts tokenize by the checkpoint's
tokenizer, or by hashing each lowercased word into the vocabulary.

``torch_embed_func`` and ``torch_classify_func`` make the device Funcs that
``functions.ai.embed_text`` / ``classify_text`` call with
``provider="torch"``; classify runs the encoder and the argmax against the
label matrix in one function and returns int32 codes. The eager
``embed_text`` / ``classify_text`` methods (the provider protocol, and the
label matrices) run on the configured device, or on the CPU under
``device_mode="off"`` (ops/udf_stage.py ``host_path_device``), over the
same resident weights as the device tier.
"""

from __future__ import annotations

import hashlib
import math
import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .provider import Provider


def _seed_of(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big")


_LAYER_KEYS = ("q", "qb", "k", "kb", "v", "vb", "o", "ob", "ln1_g", "ln1_b",
               "up", "upb", "down", "downb", "ln2_g", "ln2_b")


def flat_params(nested: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The encoder's parameter dict (the ``Encoder`` module's names:
    ``tok``, ``pos``, ``ln0_g``, ``ln0_b``, ``layers.<i>.<key>``) from the
    reference's nested layout ({..., "layers": [{"q": ..., ...}, ...]})."""
    out = {k: nested[k] for k in ("tok", "pos", "ln0_g", "ln0_b")}
    for i, layer in enumerate(nested["layers"]):
        for k in _LAYER_KEYS:
            out[f"layers.{i}.{k}"] = layer[k]
    return out


class TorchEncoderWeights:
    """BERT-family encoder weights: the parameter dict (numpy) and the shape."""

    def __init__(self, params: Dict[str, np.ndarray], vocab: int, dim: int, layers: int,
                 heads: int, max_len: int, tokenizer: Any = None):
        self.params = params
        self.vocab = vocab
        self.dim = dim
        self.layers = layers
        self.heads = heads
        self.max_len = max_len
        self.tokenizer = tokenizer  # a transformers tokenizer, or None (hashing)

    @classmethod
    def seeded(cls, model_name: str, vocab: int = 8192, dim: int = 128, layers: int = 2,
               heads: int = 4, max_len: int = 128) -> "TorchEncoderWeights":
        """Weights drawn from the model name's seed, as the reference draws
        them (the same calls in the same order)."""
        rng = np.random.default_rng(_seed_of(model_name))

        def mat(*shape):
            return rng.standard_normal(shape).astype(np.float32) * 0.02

        nested = {"tok": mat(vocab, dim), "pos": mat(max_len, dim),
                  "ln0_g": np.ones(dim, np.float32), "ln0_b": np.zeros(dim, np.float32),
                  "layers": []}
        for _ in range(layers):
            nested["layers"].append({
                "q": mat(dim, dim), "qb": np.zeros(dim, np.float32),
                "k": mat(dim, dim), "kb": np.zeros(dim, np.float32),
                "v": mat(dim, dim), "vb": np.zeros(dim, np.float32),
                "o": mat(dim, dim), "ob": np.zeros(dim, np.float32),
                "ln1_g": np.ones(dim, np.float32), "ln1_b": np.zeros(dim, np.float32),
                "up": mat(dim, dim * 4), "upb": np.zeros(dim * 4, np.float32),
                "down": mat(dim * 4, dim), "downb": np.zeros(dim, np.float32),
                "ln2_g": np.ones(dim, np.float32), "ln2_b": np.zeros(dim, np.float32),
            })
        return cls(flat_params(nested), vocab, dim, layers, heads, max_len)

    @classmethod
    def from_local_checkpoint(cls, model_name: str,
                              max_len: int = 128) -> Optional["TorchEncoderWeights"]:
        """A local transformers BERT-family checkpoint's weights (no network:
        ``local_files_only``), or None when there is none on disk or no
        transformers package to read it."""
        if not _checkpoint_on_disk(model_name):
            return None
        try:
            from transformers import AutoModel, AutoTokenizer

            tok = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
            model = AutoModel.from_pretrained(model_name, local_files_only=True)
        except (ImportError, OSError, ValueError):
            return None
        sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
        cfg = model.config
        pre, enc = "embeddings.", "encoder.layer."
        if f"{pre}word_embeddings.weight" not in sd:
            return None
        nested = {"tok": sd[f"{pre}word_embeddings.weight"],
                  "pos": sd[f"{pre}position_embeddings.weight"][:max_len],
                  "ln0_g": sd[f"{pre}LayerNorm.weight"], "ln0_b": sd[f"{pre}LayerNorm.bias"],
                  "layers": []}
        if f"{pre}token_type_embeddings.weight" in sd:
            nested["tok"] = nested["tok"] + sd[f"{pre}token_type_embeddings.weight"][0]
        names = {"q": "attention.self.query", "k": "attention.self.key",
                 "v": "attention.self.value", "o": "attention.output.dense",
                 "up": "intermediate.dense", "down": "output.dense"}
        for i in range(cfg.num_hidden_layers):
            b = f"{enc}{i}."
            layer = {}
            for k, src in names.items():
                layer[k] = sd[f"{b}{src}.weight"].T
                layer[k + "b"] = sd[f"{b}{src}.bias"]
            layer.update({"ln1_g": sd[f"{b}attention.output.LayerNorm.weight"],
                          "ln1_b": sd[f"{b}attention.output.LayerNorm.bias"],
                          "ln2_g": sd[f"{b}output.LayerNorm.weight"],
                          "ln2_b": sd[f"{b}output.LayerNorm.bias"]})
            nested["layers"].append(layer)
        return cls(flat_params(nested), cfg.vocab_size, cfg.hidden_size,
                   cfg.num_hidden_layers, cfg.num_attention_heads, max_len, tokenizer=tok)


def _checkpoint_on_disk(model_name: str) -> bool:
    """Whether ``model_name`` is a local checkpoint directory or is in the
    Hugging Face hub cache: only then is transformers imported."""
    if os.path.isfile(os.path.join(model_name, "config.json")):
        return True
    hub = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache",
                                                  "huggingface"), "hub")
    return os.path.isdir(os.path.join(hub, "models--" + model_name.replace("/", "--")))


def _ln(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-12) * g + b


class _Layer(nn.Module):
    def __init__(self, dim: int, ffn: int):
        super().__init__()
        shapes = {"q": (dim, dim), "qb": (dim,), "k": (dim, dim), "kb": (dim,),
                  "v": (dim, dim), "vb": (dim,), "o": (dim, dim), "ob": (dim,),
                  "ln1_g": (dim,), "ln1_b": (dim,), "up": (dim, ffn), "upb": (ffn,),
                  "down": (ffn, dim), "downb": (dim,), "ln2_g": (dim,), "ln2_b": (dim,)}
        for k in _LAYER_KEYS:
            self.register_parameter(k, nn.Parameter(torch.empty(shapes[k])))


class Encoder(nn.Module):
    """The encoder's computation; ``fwd(params, ids, mask)`` runs it over a
    parameter dict with ``torch.func.functional_call`` (the module itself
    lives on the meta device and holds no weights)."""

    def __init__(self, vocab: int, dim: int, layers: int, heads: int, max_len: int,
                 ffn: int):
        super().__init__()
        self.heads = heads
        self.tok = nn.Parameter(torch.empty(vocab, dim))
        self.pos = nn.Parameter(torch.empty(max_len, dim))
        self.ln0_g = nn.Parameter(torch.empty(dim))
        self.ln0_b = nn.Parameter(torch.empty(dim))
        self.layers = nn.ModuleList(_Layer(dim, ffn) for _ in range(layers))

    def forward(self, ids, mask):
        """ids [B, L] int, mask [B, L] f32 -> [B, dim] unit-norm embeddings."""
        B, L = ids.shape
        H = self.heads
        D = self.tok.shape[1]
        hd = D // H
        x = self.tok[ids.long()] + self.pos[:L][None, :, :]
        x = _ln(x, self.ln0_g, self.ln0_b)
        attn_bias = (1.0 - mask)[:, None, None, :] * -1e9
        for lp in self.layers:
            q = (x @ lp.q + lp.qb).reshape(B, L, H, hd).transpose(1, 2)
            k = (x @ lp.k + lp.kb).reshape(B, L, H, hd).transpose(1, 2)
            v = (x @ lp.v + lp.vb).reshape(B, L, H, hd).transpose(1, 2)
            scores = (q @ k.transpose(2, 3)) / math.sqrt(hd) + attn_bias
            probs = torch.softmax(scores, dim=-1)
            ctx = (probs @ v).transpose(1, 2).reshape(B, L, D)
            x = _ln(x + (ctx @ lp.o + lp.ob), lp.ln1_g, lp.ln1_b)
            h = torch.nn.functional.gelu(x @ lp.up + lp.upb, approximate="tanh")
            x = _ln(x + (h @ lp.down + lp.downb), lp.ln2_g, lp.ln2_b)
        m = mask[:, :, None]
        pooled = (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
        return pooled / torch.clamp(torch.linalg.norm(pooled, dim=-1, keepdim=True),
                                    min=1e-9)


def encoder_for(weights: TorchEncoderWeights) -> Encoder:
    """The weights' ``Encoder`` module, on the meta device."""
    p = weights.params
    with torch.device("meta"):
        return Encoder(weights.vocab, weights.dim, weights.layers, weights.heads,
                       p["pos"].shape[0], p["layers.0.up"].shape[1] if weights.layers
                       else 4 * weights.dim)


# words hash the same in every model: word -> _seed_of(word), capped
_WORD_SEEDS: Dict[str, int] = {}
_WORD_SEEDS_CAP = 1 << 20


def _word_seeds(words: List[str]) -> np.ndarray:
    """``_seed_of`` of each word (int64), memoized across calls."""
    get = _WORD_SEEDS.get
    out = [get(w) for w in words]
    if None in out:
        if len(_WORD_SEEDS) + len(out) > _WORD_SEEDS_CAP:
            _WORD_SEEDS.clear()
        for i, s in enumerate(out):
            if s is None:
                out[i] = _WORD_SEEDS[words[i]] = _seed_of(words[i])
    return np.array(out, dtype=np.int64)


class TorchTextEmbedder:
    """Text embedder on the encoder, of ``weights`` when given (else the
    checkpoint's or the seeded ones). The ``device_params`` /
    ``device_prepare`` hooks are the device-UDF tier's contract;
    ``embed_text`` is the eager provider surface."""

    def __init__(self, model_name: str, weights: Optional[TorchEncoderWeights] = None):
        self.model_name = model_name
        self.weights = weights or (TorchEncoderWeights.from_local_checkpoint(model_name)
                                   or TorchEncoderWeights.seeded(model_name))
        self._module = None

    @property
    def dimensions(self) -> int:
        return self.weights.dim

    def device_params(self) -> Dict[str, np.ndarray]:
        """The parameter dict (host numpy): the tier fingerprints its bytes
        and keeps it resident."""
        return self.weights.params

    def device_prepare(self, texts: List[Optional[str]]):
        """Tokenize one batch; a null tokenizes as empty, so rows stay
        aligned (the engine masks it back to None)."""
        return self._tokenize(["" if t is None else t for t in texts])

    def encoder_fn(self):
        """``fwd(params, ids, mask)``: the encoder over a parameter dict of
        tensors on the inputs' device."""
        if self._module is None:
            self._module = encoder_for(self.weights)
        module = self._module

        def fwd(params, ids, mask):
            return torch.func.functional_call(module, params, (ids, mask))

        return fwd

    def _tokenize(self, texts: List[str]):
        w = self.weights
        if w.tokenizer is not None:
            enc = w.tokenizer(texts, padding="max_length", truncation=True,
                              max_length=w.max_len, return_tensors="np")
            return enc["input_ids"].astype(np.int32), enc["attention_mask"].astype(np.float32)
        # each lowercased word hashed into the vocabulary, the first max_len
        # of a text; an empty text attends to its first (id 0) token
        words = [(t or "").lower().split()[:w.max_len] for t in texts]
        lens = np.fromiter(map(len, words), dtype=np.int64, count=len(words))
        real = np.arange(w.max_len)[None, :] < lens[:, None]
        ids = np.zeros((len(texts), w.max_len), np.int32)
        ids[real] = _word_seeds([x for ws in words for x in ws]) % w.vocab
        mask = real.astype(np.float32)
        mask[lens == 0, 0] = 1.0
        return ids, mask

    def embed_text(self, texts: List[str]) -> List[np.ndarray]:
        """Embeddings of ``texts`` on ``host_path_device()``, through the
        weights resident there, padded to a power-of-two batch whose padding
        rows attend to their first token only."""
        if not texts:
            return []
        from ..ops.udf_stage import anchor_for, host_path_device, resident_params, udf_pad_bucket

        device = host_path_device()
        params = resident_params(anchor_for(self.weights.params), device)

        ids, mask = self._tokenize(texts)
        n = len(texts)
        b = udf_pad_bucket(n)
        if b > n:
            ids = np.concatenate([ids, np.zeros((b - n, ids.shape[1]), np.int32)])
            mask = np.concatenate([mask, np.zeros((b - n, mask.shape[1]), np.float32)])
            mask[n:, 0] = 1.0
        with torch.inference_mode():
            out = self.encoder_fn()(params, torch.from_numpy(ids).to(device),
                                    torch.from_numpy(mask).to(device)).cpu().numpy()
        return [out[i] for i in range(n)]


DEFAULT_MODEL = "torch-minilm-seeded"

# one embedder per model name per process (a model loads once; Funcs resolve
# through it); both caches FIFO-capped, an evicted entry is rebuilt on use
_EMBEDDERS: dict = {}
_LABEL_MATRICES: dict = {}
_EMBEDDERS_CAP = 8
_LABEL_MATRICES_CAP = 128
_PROVIDER_LOCK = threading.Lock()


def embedder_for(model_name: Optional[str]) -> TorchTextEmbedder:
    name = model_name or DEFAULT_MODEL
    with _PROVIDER_LOCK:
        e = _EMBEDDERS.get(name)
    if e is not None:
        return e
    e = TorchTextEmbedder(name)  # the model loads outside the lock
    with _PROVIDER_LOCK:
        e = _EMBEDDERS.setdefault(name, e)
        while len(_EMBEDDERS) > _EMBEDDERS_CAP:
            _EMBEDDERS.pop(next(iter(_EMBEDDERS)))
    return e


def label_matrix(embedder: TorchTextEmbedder, labels: List[str]) -> np.ndarray:
    """The [labels, dim] float32 label embeddings, cached per (model,
    labels): the eager classifier and the device tier compare against the
    same vectors."""
    key = (embedder.model_name, tuple(labels))
    with _PROVIDER_LOCK:
        lv = _LABEL_MATRICES.get(key)
    if lv is None:
        lv = np.stack(embedder.embed_text(list(labels))).astype(np.float32)
        with _PROVIDER_LOCK:
            lv = _LABEL_MATRICES.setdefault(key, lv)
            while len(_LABEL_MATRICES) > _LABEL_MATRICES_CAP:
                _LABEL_MATRICES.pop(next(iter(_LABEL_MATRICES)))
    return lv


class TorchTextClassifier:
    """Zero-shot classifier: the label whose embedding is nearest the text's
    (the largest dot product of the unit vectors, on the host, over the
    eager embeddings)."""

    def __init__(self, model_name: str):
        self.embedder = embedder_for(model_name)

    def classify_text(self, texts: List[str], labels: List[str]) -> List[str]:
        lv = label_matrix(self.embedder, labels)
        if not texts:
            return []
        tv = np.stack(self.embedder.embed_text(texts))
        return [labels[int(i)] for i in (tv @ lv.T).argmax(axis=1)]


# ---- the device Funcs ---------------------------------------------------------------


def torch_embed_func(model: Optional[str] = None, batch_size: Optional[int] = None):
    """A device Func embedding a text column: ``fn(params, ids, mask) ->
    [n, dim]`` on the device-UDF tier (weights resident, dispatches
    coalesced, tokenization on the host per batch)."""
    from ..datatype import DataType
    from ..udf.udf import Func

    name = model or DEFAULT_MODEL

    def fn(params, ids, mask):
        return embedder_for(name).encoder_fn()(params, ids, mask)

    return Func(fn=fn, return_dtype=DataType.list(DataType.float32()), is_batch=True,
                on_device=True, device_params=lambda: embedder_for(name).device_params(),
                device_prepare=lambda texts: embedder_for(name).device_prepare(texts),
                batch_size=batch_size, name=f"torch_embed[{name}]")


def torch_classify_func(labels: List[str], model: Optional[str] = None,
                        batch_size: Optional[int] = None):
    """A device Func for zero-shot classification: the encoder and the
    argmax against the label matrix in one function, so only int32 codes
    come back, decoded to labels on the host. Its weights are split: "enc"
    is the encoder's entry, shared with the embed Func and every label set
    of the model, and "lab" the label matrix's own."""
    from ..datatype import DataType
    from ..udf.udf import Func

    name = model or DEFAULT_MODEL
    labels = list(labels)

    def fn(params, ids, mask):
        emb = embedder_for(name).encoder_fn()(params["enc"], ids, mask)
        return torch.argmax(emb @ params["lab"].T, dim=1).to(torch.int32)

    def params():
        e = embedder_for(name)
        return {"enc": e.device_params(), "lab": label_matrix(e, labels)}

    return Func(fn=fn, return_dtype=DataType.string(), is_batch=True, on_device=True,
                device_params=params, device_params_split=True,
                device_prepare=lambda texts: embedder_for(name).device_prepare(texts),
                device_finish=lambda out: [labels[i] for i in out.tolist()],
                batch_size=batch_size, name=f"torch_classify[{name}]")


class TorchProvider(Provider):
    """The on-device provider, "torch" in the registry."""

    name = "torch"

    def get_text_embedder(self, model: Optional[str] = None, **options):
        return embedder_for(model)

    def get_text_classifier(self, model: Optional[str] = None, **options):
        return TorchTextClassifier(model or DEFAULT_MODEL)
