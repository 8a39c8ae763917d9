"""The text encoder and the AI functions (daft_tpu_torch/ai/,
daft_tpu_torch/functions/ai.py) against the reference's
(daft_tpu/ai/jax_provider.py, daft_tpu/functions/ai.py) on the CPU.

- The seeded weights are bit-equal, array by array, and the hash tokenizer
  gives equal ids and masks.
- The port's encoder against the reference's ``_encoder_fwd`` with the
  reference's weights carried across (``interop.encoder_params``), on the
  same token ids and masks: within 1e-6 max abs error at the reference's
  default seeded widths and at a narrow MiniLM-shaped config. The erf form
  of gelu misses this several times over on these inputs (the reference
  uses JAX's tanh approximation); float32 against the reference's float64
  scores gives under 1e-7.
- End to end: ``embed_text`` (the reference's provider "jax" on its device
  tier on JAX's CPU, the port's "torch" at ``device="cpu"``) within 1e-6,
  nulls and empty strings included; ``classify_text`` labels and the
  classify -> groupby counts equal; the host providers ("dummy") equal.

The reference's embedder constructor looks for a transformers checkpoint by
importing transformers (seconds where it is installed, and it finds no
checkpoint): the tests build its seeded embedders directly into its
per-process cache.
"""

import numpy as np
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu.ai import jax_provider as jp
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu.functions import ai as rai
from daft_tpu_torch.ai import torch_provider as tp
from daft_tpu_torch.functions import ai as pai
from daft_tpu_torch.interop import encoder_params

MODEL = "ai-parity-seeded"
LABELS = ["alpha topic", "beta topic", "gamma topic", "delta topic"]
WIDTHS = {"default": {}, "minilm_narrow": {"vocab": 30522, "dim": 96, "layers": 3,
                                           "heads": 12}}


def _ref_embedder(name: str):
    """The reference's embedder of ``name`` with seeded weights, as its
    constructor builds one when no checkpoint is found."""
    e = jp._EMBEDDERS.get(name)
    if e is None:
        e = jp.JaxTextEmbedder.__new__(jp.JaxTextEmbedder)
        e.model_name = name
        e.weights = jp.JaxEncoderWeights.seeded(name)
        e._fwd = None
        e._fwd_raw = None
        jp._EMBEDDERS[name] = e
    return e


def _texts(n: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(300)] + ["Alpha", "TOPIC", "beta"]
    out = [" ".join(rng.choice(words, rng.integers(1, 40))) for _ in range(n)]
    out[3] = " ".join(["long"] * 200)  # past max_len: truncated
    return out


def _ids_mask(rng, vocab: int, rows: int, length: int = 128):
    ids = rng.integers(0, vocab, (rows, length)).astype(np.int32)
    lens = rng.integers(0, length + 1, rows)
    lens[:3] = [0, 1, length]
    mask = (np.arange(length)[None, :] < lens[:, None]).astype(np.float32)
    mask[lens == 0, 0] = 1.0
    mask[-2:] = 0.0  # the tier's padding rows: all zero
    return ids, mask


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_seeded_weights_bit_equal(width):
    ref = jp.JaxEncoderWeights.seeded(MODEL, **WIDTHS[width])
    port = tp.TorchEncoderWeights.seeded(MODEL, **WIDTHS[width])
    carried = encoder_params(ref.params)
    assert list(carried) == list(port.params)
    for k, v in carried.items():
        assert v.dtype == port.params[k].dtype and np.array_equal(v, port.params[k]), k
    assert (port.vocab, port.dim, port.layers, port.heads, port.max_len) == \
        (ref.vocab, ref.dim, ref.layers, ref.heads, ref.max_len)


def test_tokenizer_matches_reference():
    texts = _texts(30) + [None, "", "  Mixed CASE  words "]
    ref_ids, ref_mask = _ref_embedder(MODEL).device_prepare(texts)
    ids, mask = tp.embedder_for(MODEL).device_prepare(texts)
    assert ids.dtype == ref_ids.dtype and mask.dtype == ref_mask.dtype
    assert np.array_equal(ids, ref_ids) and np.array_equal(mask, ref_mask)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_encoder_matches_reference(width):
    import jax
    import jax.numpy as jnp

    ref_w = jp.JaxEncoderWeights.seeded(MODEL, **WIDTHS[width])
    ids, mask = _ids_mask(np.random.default_rng(11), ref_w.vocab, 24)
    want = np.asarray(jax.jit(jp._encoder_fwd(ref_w))(
        jax.tree_util.tree_map(jnp.asarray, ref_w.params), jnp.asarray(ids),
        jnp.asarray(mask)))
    port_w = tp.TorchEncoderWeights.seeded(MODEL, **WIDTHS[width])
    params = {k: torch.from_numpy(v) for k, v in encoder_params(ref_w.params).items()}
    with torch.inference_mode():
        got = torch.func.functional_call(tp.encoder_for(port_w), params,
                                         (torch.from_numpy(ids), torch.from_numpy(mask)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-6, err
    # unit rows, but the all-zero padding rows, which pool to zero
    assert np.allclose(np.linalg.norm(got.numpy()[:-2], axis=1), 1.0, atol=1e-5)
    assert not got[-2:].any()


def test_label_matrix_matches_reference():
    ref = jp._label_matrix(_ref_embedder(MODEL), LABELS)
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        port = tp.label_matrix(tp.embedder_for(MODEL), LABELS)
    assert port.shape == ref.shape and port.dtype == np.float32
    assert float(np.abs(port - ref).max()) <= 1e-6


def _frames(texts):
    ids = list(range(len(texts)))
    return (daft_tpu.from_pydict({"id": ids, "t": texts}),
            daft_tpu_torch.from_pydict({"id": ids, "t": texts}))


def test_embed_text_matches_reference():
    _ref_embedder(MODEL)
    texts = _texts(40) + [None, "", None, "x"]
    rdf, pdf = _frames(texts)
    with ref_ctx(device_mode="on", device_min_rows=1, mesh_devices=1):
        ref = rdf.select(daft_tpu.col("id"), rai.embed_text(
            daft_tpu.col("t"), provider="jax", model=MODEL).alias("e")).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="on"):
        port = pdf.select(daft_tpu_torch.col("id"), pai.embed_text(
            daft_tpu_torch.col("t"), provider="torch", model=MODEL).alias("e")).to_pydict()
    assert port["id"] == ref["id"]
    assert [v is None for v in port["e"]] == [v is None for v in ref["e"]] == \
        [t is None for t in texts]
    err = max(float(np.abs(np.asarray(p) - np.asarray(r)).max())
              for p, r in zip(port["e"], ref["e"]) if p is not None)
    assert err <= 1e-6, err


def test_classify_text_and_groupby_match_reference():
    _ref_embedder(MODEL)
    texts = _texts(120, seed=9) + [None, ""]
    rdf, pdf = _frames(texts)
    with ref_ctx(device_mode="on", device_min_rows=1, mesh_devices=1):
        ref = rdf.select(rai.classify_text(daft_tpu.col("t"), LABELS, provider="jax",
                                           model=MODEL).alias("label")).to_pydict()
        ref_counts = (rdf.select(daft_tpu.col("id"), rai.classify_text(
            daft_tpu.col("t"), LABELS, provider="jax", model=MODEL).alias("label"))
            .groupby("label").agg(daft_tpu.col("id").count().alias("n"))
            .sort("label").to_pydict())
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="on"):
        port = pdf.select(pai.classify_text(daft_tpu_torch.col("t"), LABELS, provider="torch",
                                            model=MODEL).alias("label")).to_pydict()
        port_counts = (pdf.select(daft_tpu_torch.col("id"), pai.classify_text(
            daft_tpu_torch.col("t"), LABELS, provider="torch", model=MODEL).alias("label"))
            .groupby("label").agg(daft_tpu_torch.col("id").count().alias("n"))
            .sort("label").to_pydict())
    assert port == ref
    assert port_counts == ref_counts
    assert len(set(port["label"]) - {None}) >= 2


def test_eager_provider_surface_matches_reference():
    texts = _texts(12, seed=2)
    ref = np.stack(_ref_embedder(MODEL).embed_text(texts))
    provider = daft_tpu_torch.ai.get_provider("torch")
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        port = np.stack(provider.get_text_embedder(MODEL).embed_text(texts))
        labels = provider.get_text_classifier(MODEL).classify_text(texts, LABELS)
    assert float(np.abs(port - ref).max()) <= 1e-6
    ref_clf = jp.JaxTextClassifier.__new__(jp.JaxTextClassifier)
    ref_clf.embedder = _ref_embedder(MODEL)
    assert labels == ref_clf.classify_text(texts, LABELS)


def test_eager_provider_surface_runs_on_the_configured_device(monkeypatch):
    """The eager embedder and classifier run on the configured device: the
    default one raises with no card, device_mode="off" runs on the CPU and
    gives device="cpu"'s vectors."""
    texts = _texts(5, seed=4)
    provider = daft_tpu_torch.ai.get_provider("torch")
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        want = np.stack(provider.get_text_embedder(MODEL).embed_text(texts))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with daft_tpu_torch.execution_config_ctx(device="cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            provider.get_text_embedder(MODEL).embed_text(texts)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            provider.get_text_classifier(MODEL).classify_text(texts, ["new", "labels"])
        with daft_tpu_torch.execution_config_ctx(device_mode="off"):
            got = np.stack(provider.get_text_embedder(MODEL).embed_text(texts))
    assert float(np.abs(got - want).max()) <= 1e-6


@pytest.mark.parametrize("fn", ["embed_text", "classify_text", "prompt", "llm_generate",
                                "embed_image"])
def test_host_provider_functions_match_reference(fn):
    texts = ["a b", None, "c", "d e f"]
    rdf, pdf = _frames(texts)

    def call(mod, dt):
        c = dt.col("t")
        if fn == "classify_text":
            return mod.classify_text(c, LABELS, provider="dummy")
        if fn == "prompt":
            return mod.prompt(c, provider="dummy", model="m")
        return getattr(mod, fn)(c, provider="dummy")

    ref = rdf.select(call(rai, daft_tpu).alias("o")).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        port = pdf.select(call(pai, daft_tpu_torch).alias("o")).to_pydict()
    if fn in ("embed_text", "embed_image"):
        assert [v is None for v in port["o"]] == [v is None for v in ref["o"]]
        assert all(np.array_equal(np.float32(p), np.float32(r))
                   for p, r in zip(port["o"], ref["o"]) if p is not None)
    else:
        assert port == ref


def test_device_options_are_checked():
    with pytest.raises(TypeError, match="batch_size only"):
        pai.embed_text(daft_tpu_torch.col("t"), provider="torch", device="cuda")
    with pytest.raises(ValueError, match="unknown AI provider"):
        daft_tpu_torch.ai.get_provider("transformers")
