"""A reader for HuggingFace ``tokenizer.json`` files: the port's counterpart
of ``tokenizers.Tokenizer.from_file`` / ``encode(text).ids`` /
``decode(ids)``, which the reference calls in
daft_tpu/functions/registry.py:967-1023.

What it reads:

- model ``BPE``, its merges as ``"a b"`` strings or as pairs,
  ``ignore_merges``, an ``unk_token``; no dropout, no subword prefix or
  suffix, no byte fallback;
- ``added_tokens`` (special or not), split out of the text before
  pre-tokenizing as ``tokenizers`` splits them: leftmost-longest, the
  tokens that are not ``normalized`` from the raw text first, the others
  from the normalized pieces; ``lstrip`` / ``rstrip`` / ``single_word``;
- normalizer ``null``, ``NFC``, ``NFKC``, ``Lowercase`` (char by char, as
  Rust's ``char::to_lowercase``) or a ``Sequence`` of them;
- pre-tokenizer and decoder ``ByteLevel`` (GPT-2's byte-to-unicode map,
  ``add_prefix_space``, the GPT-2 split pattern), post-processor
  ``ByteLevel`` or ``null`` (neither adds an id).

The GPT-2 pattern needs ``\\p{L}`` and ``\\p{N}``, which Python's ``re``
lacks: the letter, number and whitespace classes (Oniguruma's ``\\s``:
tab to carriage return, U+0085 and the Zs / Zl / Zp categories) are built
once from ``unicodedata`` categories, a class per code point. The host
kernel library scans the text's code points with them and keeps each
word's ids in a table, as ``tokenizers``' BPE keeps a cache (native.py
``bpe_encode``: only a word it has not seen comes back to be merged here);
its plain version runs the same pattern in ``re``, the classes spelled out
as ranges, and keeps the words in a dict. Any other model, normalizer,
pre-tokenizer, post-processor or decoder raises ``NotImplementedError``
naming ROADMAP Queue 1's tokenizer-model entry.
"""

from __future__ import annotations

import json
import re
import threading
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native

DEFERRED_MODELS = ("the tokenizer-models entry of ROADMAP Queue 1 (WordPiece, Unigram, "
                   "Metaspace and the other tokenizer.json components)")


def _deferred(what: str) -> NotImplementedError:
    return NotImplementedError(f"tokenizer {what} is not supported by the port yet: it comes "
                               f"with {DEFERRED_MODELS}")


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 bytes to printable characters."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + \
        list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


# byte -> its character; str.translate of a word's UTF-8 bytes read as latin-1
_BYTE_CHAR = bytes_to_unicode()
_CHAR_BYTE = {c: b for b, c in _BYTE_CHAR.items()}

_SPLIT = None
_SPLIT_LOCK = threading.Lock()


def _ranges(flags, value: int) -> str:
    """A character class body of the code points whose class is ``value``."""
    cps = np.flatnonzero(flags == value)
    if len(cps) == 0:
        return ""
    cut = np.flatnonzero(np.diff(cps) != 1)
    starts = np.concatenate([cps[:1], cps[cut + 1]]).tolist()
    stops = np.concatenate([cps[cut], cps[-1:]]).tolist()
    esc = "\\U%08x"
    return "".join(esc % a if a == b else f"{esc % a}-{esc % b}" for a, b in zip(starts, stops))


def gpt2_classes():
    """(a uint8 class per code point: 0 other, 1 letter, 2 number, 3
    whitespace as Oniguruma's ``\\s``; GPT-2's split pattern, ``'s|'t|'re|
    've|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``, with its
    classes spelled out for ``re``), built once from ``unicodedata``."""
    global _SPLIT
    with _SPLIT_LOCK:
        if _SPLIT is None:
            flags = np.zeros(0x110000, dtype=np.uint8)
            for cp in range(0x110000):
                cat = unicodedata.category(chr(cp))
                if cat[0] == "L":
                    flags[cp] = 1
                elif cat[0] == "N":
                    flags[cp] = 2
                elif cat in ("Zs", "Zl", "Zp") or cp in (9, 10, 11, 12, 13, 0x85):
                    flags[cp] = 3
            letter, number, space = (_ranges(flags, v) for v in (1, 2, 3))
            pattern = re.compile(
                f"'s|'t|'re|'ve|'m|'ll|'d| ?[{letter}]+| ?[{number}]+"
                f"| ?[^{space}{letter}{number}]+|[{space}]+(?![^{space}])|[{space}]+")
            _SPLIT = (flags, pattern)
        return _SPLIT


def _lower(text: str) -> str:
    # char by char, as Rust's char::to_lowercase: str.lower's final-sigma rule aside
    return text.lower() if "Σ" not in text else "".join(c.lower() for c in text)


def _normalizer(spec) -> List[str]:
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [step for sub in spec.get("normalizers", []) for step in _normalizer(sub)]
    if kind in ("NFC", "NFKC", "Lowercase"):
        return [kind]
    raise _deferred(f"normalizer {kind!r}")


class AddedToken:
    __slots__ = ("id", "content", "special", "normalized", "lstrip", "rstrip", "single_word")

    def __init__(self, d):
        self.id = int(d["id"])
        self.content = d["content"]
        self.special = bool(d.get("special", False))
        self.normalized = bool(d.get("normalized", not self.special))
        self.lstrip = bool(d.get("lstrip", False))
        self.rstrip = bool(d.get("rstrip", False))
        self.single_word = bool(d.get("single_word", False))


class TokenizerFile:
    """One ``tokenizer.json`` read into memory; ``encode`` and ``decode``
    give what ``tokenizers`` gives for it."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            raise _deferred(f"model {model.get('type')!r}")
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key):
                raise _deferred(f"BPE option {key}={model[key]!r}")
        if model.get("byte_fallback"):
            raise _deferred("BPE option byte_fallback")
        self.vocab: Dict[str, int] = dict(model.get("vocab", {}))
        self.ignore_merges = bool(model.get("ignore_merges", False))
        unk = model.get("unk_token")
        self.unk_id = self.vocab.get(unk) if unk is not None else None
        self.fuse_unk = bool(model.get("fuse_unk", False))
        self.ranks: Dict[Tuple[str, str], int] = {}
        for rank, m in enumerate(model.get("merges", [])):
            pair = tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
            if len(pair) != 2 or pair[0] + pair[1] not in self.vocab:
                raise ValueError(f"merge {m!r} makes no token of the vocabulary")
            self.ranks.setdefault(pair, rank)
        self.added = [AddedToken(d) for d in spec.get("added_tokens") or []]
        self.id_to_token: Dict[int, str] = {i: t for t, i in self.vocab.items()}
        for a in self.added:
            self.id_to_token[a.id] = a.content
        self.special_ids = {a.id for a in self.added if a.special}
        self.added_by_content = {a.content: a for a in self.added}
        self.raw_split = self._splitter([a for a in self.added if not a.normalized])
        self.norm_split = self._splitter([a for a in self.added if a.normalized])
        self.normalize_steps = _normalizer(spec.get("normalizer"))
        pre = spec.get("pre_tokenizer")
        if pre is None:
            self.prefix_space, self.use_regex, self.byte_level = False, False, False
        elif pre.get("type") == "ByteLevel":
            self.prefix_space = bool(pre.get("add_prefix_space", True))
            self.use_regex = bool(pre.get("use_regex", True))
            self.byte_level = True
        else:
            raise _deferred(f"pre-tokenizer {pre.get('type')!r}")
        post = spec.get("post_processor")
        if post is not None and post.get("type") != "ByteLevel":
            raise _deferred(f"post-processor {post.get('type')!r}")
        dec = spec.get("decoder")
        if dec is not None and dec.get("type") != "ByteLevel":
            raise _deferred(f"decoder {dec.get('type')!r}")
        self.byte_decoder = dec is not None
        self.cache = native.BpeCache()

    @staticmethod
    def _splitter(tokens: Sequence[AddedToken]):
        if not tokens:
            return None
        alts = sorted({a.content for a in tokens if a.content}, key=len, reverse=True)
        return re.compile("|".join(re.escape(a) for a in alts)) if alts else None

    # ---- encode -------------------------------------------------------------------

    def _normalize(self, text: str) -> str:
        for step in self.normalize_steps:
            text = _lower(text) if step == "Lowercase" else unicodedata.normalize(step, text)
        return text

    def _split_added(self, pieces, pattern):
        """Cut the added tokens (``pattern``) out of the pieces not yet
        matched: a matched piece is (None, token)."""
        if pattern is None:
            return pieces
        out = []
        for text, tok in pieces:
            if tok is not None:
                out.append((text, tok))
                continue
            pos = 0
            for m in pattern.finditer(text):
                a = self.added_by_content[m.group()]
                s, e = m.start(), m.end()
                if a.single_word and ((s > 0 and _is_word(text[s - 1]))
                                      or (e < len(text) and _is_word(text[e]))):
                    continue
                if s < pos:
                    continue
                if a.lstrip:
                    while s > pos and text[s - 1].isspace():
                        s -= 1
                if a.rstrip:
                    while e < len(text) and text[e].isspace():
                        e += 1
                if s > pos:
                    out.append((text[pos:s], None))
                out.append((None, a))
                pos = e
            if pos < len(text):
                out.append((text[pos:], None))
        return out

    def encode(self, text: str) -> List[int]:
        return self.encode_ids(text).tolist()

    def encode_ids(self, text: str) -> np.ndarray:
        """``text``'s token ids (int32), as ``tokenizers``' ``encode(text).ids``."""
        pieces = self._split_added([(text, None)], self.raw_split)
        pieces = [(self._normalize(t) if a is None else t, a) for t, a in pieces]
        pieces = self._split_added(pieces, self.norm_split)
        parts = []
        for piece, tok in pieces:
            if tok is not None:
                parts.append(np.array([tok.id], dtype=np.int32))
            elif piece:
                parts.append(self._encode_piece(piece))
        return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int32)

    def _encode_piece(self, piece: str) -> np.ndarray:
        if self.byte_level and self.prefix_space and not piece.startswith(" "):
            piece = " " + piece
        if not self.use_regex:
            return np.array(self._word_ids(piece), dtype=np.int32)
        return native.bpe_encode(self.cache, piece, *gpt2_classes(), self._word_ids)

    def _word_ids(self, word: str) -> Tuple[int, ...]:
        level = word.encode("utf-8").decode("latin-1").translate(_BYTE_CHAR) \
            if self.byte_level else word
        return self._bpe(level)

    def _bpe(self, word: str) -> Tuple[int, ...]:
        vocab = self.vocab
        if self.ignore_merges and word in vocab:
            return (vocab[word],)
        syms = []
        for ch in word:
            if ch in vocab:
                syms.append(ch)
            elif self.unk_id is not None:
                if not (self.fuse_unk and syms and syms[-1] is None):
                    syms.append(None)
        ranks = self.ranks
        while len(syms) > 1:
            best, at = None, -1
            for i in range(len(syms) - 1):
                a, b = syms[i], syms[i + 1]
                if a is None or b is None:
                    continue
                r = ranks.get((a, b))
                if r is not None and (best is None or r < best):
                    best, at = r, i
            if best is None:
                break
            syms[at:at + 2] = [syms[at] + syms[at + 1]]
        return tuple(self.unk_id if s is None else vocab[s] for s in syms)

    # ---- decode -------------------------------------------------------------------

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            t = self.id_to_token.get(int(i))
            if t is None or (skip_special_tokens and int(i) in self.special_ids):
                continue
            tokens.append(t)
        if not self.byte_decoder:
            return " ".join(tokens)
        raw = bytearray()
        for t in tokens:
            try:
                raw.extend(_CHAR_BYTE[c] for c in t)
            except KeyError:
                raw.extend(t.encode("utf-8"))
        return raw.decode("utf-8", "replace")


def _is_word(c: str) -> bool:
    return c.isalnum() or c == "_"


def from_file(path: str) -> TokenizerFile:
    """Read ``path`` (a ``tokenizer.json``); a file that is not one raises
    ValueError, as ``tokenizers`` raises its own Exception."""
    with open(path, encoding="utf-8") as f:
        try:
            spec = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path} is not a tokenizer.json file: {e}") from e
    if not isinstance(spec, dict) or "model" not in spec:
        raise ValueError(f"{path} is not a tokenizer.json file: it has no model")
    return TokenizerFile(spec)


_LOADED: Dict[str, Optional[TokenizerFile]] = {}
_LOADED_LOCK = threading.Lock()


def load_tokenizer(name: str) -> Optional[TokenizerFile]:
    """The "bytes" tokenizer (None: UTF-8 byte ids) or the file at
    ``name``, read once per process (registry.py:971-990's cache and lock:
    read outside the lock, the last reader's copy kept)."""
    with _LOADED_LOCK:
        if name in _LOADED:
            return _LOADED[name]
    tok = None if name == "bytes" else from_file(name)
    with _LOADED_LOCK:
        _LOADED[name] = tok
    return tok
