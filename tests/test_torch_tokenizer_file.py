"""The tokenizer-file reader (functions/tokenizer_file.py) against the
``tokenizers`` package, which the reference's ``tokenize_encode`` /
``tokenize_decode`` call (daft_tpu/functions/registry.py:967-1023):

- byte-level BPE tokenizers trained here with ``tokenizers`` (no
  download), their files read by both: token ids and decoded text equal
  over ASCII, contractions, digits, whitespace runs, CJK, Cyrillic, Greek,
  emoji, added and special tokens, with merges written as "a b" strings
  and as pairs, with ``add_prefix_space``, ``ignore_merges``, each
  normalizer (NFC, NFKC, Lowercase, a Sequence);
- ``tokenize_encode`` / ``tokenize_decode`` through a DataFrame equal to
  the reference's, nulls kept; the committed W1 tokenizer
  (tests/data/w1_tokenizer.json) on W1's texts;
- the host library's split and word table (``bpe_encode``) equal to its
  plain version (the same pattern in ``re``, a dict), over texts that
  stress the split and with a table emptied within and between calls; a
  text with more distinct words than the table holds equal to
  ``tokenizers``;
- other models raise NotImplementedError, "r50k_base" (no such file)
  raises as the reference does.
"""

import json
import os

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch import col, native
from daft_tpu_torch.functions import tokenizer_file as tf

tokenizers = pytest.importorskip("tokenizers")
from tokenizers import (Tokenizer, decoders, models, normalizers,  # noqa: E402
                        pre_tokenizers, processors, trainers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W1_TOKENIZER = os.path.join(REPO, "tests", "data", "w1_tokenizer.json")

CORPUS = [
    "hello world, it's the 2024 test ... we'll see; I'M sure they've done it",
    "   multiple   spaces\n\n\tand tabs  end  ",
    "numbers 1234567 3.14 ١٢٣ ½ and 00042",
    "ÀÉÎõü straße İstanbul ΣΑΣ σοφία Привет мир",
    "你好世界，这是一个测试。日本語のテキスト",
    "emoji 👍🏽 family 👨‍👩‍👧 party 🎉🎉 ok",
] * 20
TEXTS = CORPUS[:6] + [
    "", " ", "  a", "a  ", "\n", "x y", "a\x1cb", " z", "it's", "'s'S 'LL 're've'd'm't",
    "<|endoftext|>hi<|endoftext|> there", "end<|endoftext|>", "ΣΑΣ final ς",
    "x" * 300, "a\u0085b c　d", "i̇", "ﬁ ﬀ ① ℌ", "tab\there\r\nCRLF",
    "<pad>padded <pad> twice", "mixed 中文 and English 123abc",
]


def _trained(norm=None, prefix=False, pairs=False, ignore_merges=False, added=()):
    tok = Tokenizer(models.BPE(ignore_merges=ignore_merges))
    if norm is not None:
        tok.normalizer = norm
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=prefix)
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=True)
    trainer = trainers.BpeTrainer(vocab_size=700, special_tokens=["<|endoftext|>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                  show_progress=False)
    tok.train_from_iterator(CORPUS, trainer)
    if added:
        tok.add_tokens(list(added))
    spec = json.loads(tok.to_str())
    spec["model"]["merges"] = [
        (m.split(" ", 1) if isinstance(m, str) else m) if pairs
        else (" ".join(m) if isinstance(m, list) else m) for m in spec["model"]["merges"]]
    return spec


CONFIGS = {
    "plain": {},
    "prefix_space": {"prefix": True},
    "merges_as_pairs": {"pairs": True},
    "nfc": {"norm": normalizers.NFC()},
    "nfkc": {"norm": normalizers.NFKC()},
    "lowercase": {"norm": normalizers.Lowercase()},
    "sequence": {"norm": normalizers.Sequence([normalizers.NFKC(), normalizers.Lowercase()])},
    "ignore_merges": {"ignore_merges": True},
    "added_tokens": {"added": ("<pad>", "padded")},
}


def _write(tmp_path, spec, name="tokenizer.json"):
    path = os.path.join(tmp_path, name)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f)
    return path


@pytest.mark.parametrize("plain", [False, True], ids=["library", "plain"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_encode_decode_equal_tokenizers(config, plain, tmp_path, monkeypatch):
    spec = _trained(**CONFIGS[config])
    path = _write(tmp_path, spec)
    ref = Tokenizer.from_file(path)
    if plain:
        monkeypatch.setenv(native.DISABLE_ENV, "1")
    mine = tf.from_file(path)
    for t in TEXTS:
        ids = ref.encode(t).ids
        assert mine.encode(t) == ids, t
        assert mine.decode(ids) == ref.decode(ids), t
        assert mine.decode(ids, skip_special_tokens=False) == \
            ref.decode(ids, skip_special_tokens=False), t


def test_both_merge_forms_read_the_same(tmp_path):
    a = tf.TokenizerFile(_trained(pairs=True))
    b = tf.TokenizerFile(_trained(pairs=False))
    assert a.ranks == b.ranks
    assert [a.encode(t) for t in TEXTS] == [b.encode(t) for t in TEXTS]


def test_decode_of_unknown_and_partial_bytes_equals_tokenizers(tmp_path):
    path = _write(tmp_path, _trained())
    ref, mine = Tokenizer.from_file(path), tf.from_file(path)
    rng = np.random.default_rng(3)
    for _ in range(30):
        ids = rng.integers(0, ref.get_vocab_size() + 5, int(rng.integers(0, 12))).tolist()
        assert mine.decode(ids) == ref.decode(ids), ids


def test_frame_tokenize_equals_reference(tmp_path):
    path = _write(tmp_path, _trained(added=("<pad>",)))
    data = {"t": TEXTS + [None]}
    want = daft_tpu.from_pydict(data).select(
        daft_tpu.col("t").tokenize_encode(path).alias("ids"),
        daft_tpu.col("t").tokenize_encode(path).tokenize_decode(path).alias("back"),
        daft_tpu.col("t").tokenize_encode(path).list.length().alias("n")).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = daft_tpu_torch.from_pydict(data).select(
            col("t").tokenize_encode(path).alias("ids"),
            col("t").tokenize_encode(path).tokenize_decode(path).alias("back"),
            col("t").tokenize_encode(path).list.length().alias("n")).to_pydict()
    assert got == want
    assert got["ids"][-1] is None and got["back"][-1] is None


def test_committed_w1_tokenizer_equals_tokenizers_on_w1_texts(monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    ref, mine = Tokenizer.from_file(W1_TOKENIZER), tf.from_file(W1_TOKENIZER)
    assert ref.get_vocab_size() == 4096
    texts = cs.crawl_texts(np.random.default_rng(11), 40, cs.crawl_vocabulary())
    for t in texts:
        ids = ref.encode(t).ids
        assert mine.encode(t) == ids
        assert mine.decode(ids) == ref.decode(ids) == t


@pytest.mark.parametrize("seed", range(4))
def test_bpe_encode_library_equals_plain(seed, monkeypatch):
    flags, pattern = tf.gpt2_classes()
    tok = tf.from_file(W1_TOKENIZER)
    rng = np.random.default_rng(seed)
    pool = list("ab Z9'sv\t\n\r  ,.!é中дß👍\u0085　\x1c") + ["'s", "'re", "'ll", " 's"]
    texts = ["".join(rng.choice(pool, int(rng.integers(0, 40)))) for _ in range(200)]
    small = native.BpeCache(max_words=3)  # emptied every few words, within a call too
    lib = [native.bpe_encode(small, t, flags, pattern, tok._word_ids).tolist() for t in texts]
    shared = native.BpeCache()
    again = [native.bpe_encode(shared, t, flags, pattern, tok._word_ids).tolist()
             for t in texts + texts]
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    plain = [native.bpe_encode(native.BpeCache(), t, flags, pattern, tok._word_ids).tolist()
             for t in texts]
    assert lib == plain and again == plain + plain
    assert [tok.encode(t) for t in texts] == plain


@pytest.mark.parametrize("plain", [False, True], ids=["library", "plain"])
def test_more_distinct_words_than_the_cache_holds_equal_tokenizers(plain, monkeypatch):
    ref, mine = Tokenizer.from_file(W1_TOKENIZER), tf.from_file(W1_TOKENIZER)
    if plain:
        monkeypatch.setenv(native.DISABLE_ENV, "1")
    mine.cache = native.BpeCache(max_words=16)
    rng = np.random.default_rng(5)
    letters = list("abcdefghijklmnopqrstuvwxyzéдж中")
    words = ["".join(rng.choice(letters, int(rng.integers(2, 9)))) for _ in range(600)]
    text = " ".join(words + words[::7])  # 600 words, some twice, against 16 slots
    ids = ref.encode(text).ids
    assert mine.encode(text) == ids
    assert mine.encode(text) == ids  # again, over what the first call left in the cache


def test_other_models_raise_not_implemented(tmp_path):
    for model in ({"type": "WordPiece", "vocab": {"a": 0}},
                  {"type": "Unigram", "vocab": [["a", 0.0]]}):
        path = _write(tmp_path, {"model": model}, f"{model['type']}.json")
        with pytest.raises(NotImplementedError, match="tokenizer-models"):
            tf.from_file(path)
    spec = _trained()
    spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁"}
    with pytest.raises(NotImplementedError, match="Metaspace"):
        tf.TokenizerFile(spec)


def test_default_tokenizer_name_is_no_file_in_both():
    with pytest.raises(Exception):
        daft_tpu.from_pydict({"t": ["x"]}).select(daft_tpu.col("t").str.tokenize_encode()) \
            .to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"), pytest.raises(OSError):
        daft_tpu_torch.from_pydict({"t": ["x"]}).select(col("t").str.tokenize_encode()) \
            .to_pydict()
