"""A reader of ``tokenizer.json`` on the standard library
(dsocr_tpu/utils/tokenizer.py loads it with the ``tokenizers`` package,
which the card's machine lacks).

``load_tokenizer(path)`` → ``TokenizerAdapter`` with the reference's
surface: ``encode(text)`` without special tokens, ``decode(ids,
skip_special_tokens)`` and ``token_to_id``. It gives the ids and text of
the Rust library for what a DeepSeek-shaped byte-level BPE and a
SentencePiece-converted BPE (PaddleOCR-VL's ERNIE shape: a Metaspace
pre-tokenizer, or Prepend + Replace normalizers, over byte fallback) need:

- the model: ``BPE`` (merge ranks, ``unk_token``, ``fuse_unk``,
  ``byte_fallback``, ``ignore_merges``, ``continuing_subword_prefix``,
  ``end_of_word_suffix``; merges as "a b" strings or [a, b] pairs);
- normalizers: none, ``NFC``, ``NFKC``, ``Prepend`` (before a non-empty
  text), ``Replace`` (a string or regex pattern), ``Sequence``;
- pre-tokenizers: ``Split`` (string or Oniguruma regex, every
  ``behavior``, ``invert``; utils/onig_regex.py translates the regex),
  ``ByteLevel`` (``add_prefix_space``, ``use_regex`` with GPT-2's
  pattern), ``Digits``, ``Metaspace`` (``replacement``, ``prepend_scheme``
  ``always``/``first``/``never`` or the older ``add_prefix_space``,
  ``split``; ``first`` prepends only to the piece that starts the input),
  ``Sequence``;
- decoders: ``ByteLevel``, ``ByteFallback``, ``Fuse``, ``Strip``,
  ``Replace``, ``Metaspace``, ``Sequence`` (none: tokens joined by
  spaces);
- added tokens, matched leftmost-longest before normalization (those with
  ``normalized`` after it), with ``special``, ``lstrip``, ``rstrip`` and
  ``single_word``.

Any other component type, a BPE ``dropout``, truncation or padding raises
naming it. The post-processor is not read: encoding without special
tokens leaves the ids as the model gave them. Decoding skips ids outside
the vocabulary, as the library does, and turns invalid UTF-8 into
U+FFFD by the same maximal-subpart rule (Rust's ``from_utf8_lossy`` and
Python's "replace" handler agree), so a chunk boundary inside a
character decodes as the library decodes it.
"""

from __future__ import annotations

import json
import pathlib
import re
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .onig_regex import WHITE_SPACE, category, compile_onig

GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
_WHITE_SPACE = frozenset(chr(c) for a, b in WHITE_SPACE for c in range(a, b + 1))


class UnsupportedTokenizer(ValueError):
    """A tokenizer.json component the reader does not implement."""


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte → printable character map (ByteLevel)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), 256))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTES_CHAR = _bytes_to_unicode()
CHAR_BYTES = {c: b for b, c in BYTES_CHAR.items()}


def _unsupported(kind: str, spec) -> UnsupportedTokenizer:
    name = spec.get("type") if isinstance(spec, dict) else spec
    return UnsupportedTokenizer(f"unsupported {kind} type {name!r}")


# the circled and squared Latin letters: Other_Alphabetic symbols (So)
_ALPHABETIC_SYMBOLS = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169), (0x1F170, 0x1F189))


def _is_word_char(ch: str) -> bool:
    """A word character as a single_word added token's neighbour (the
    library's Unicode \\w: Alphabetic, marks, Nd, Pc, ZWNJ and ZWJ)."""
    cat = category(ch)
    return (cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or ch in "\u200c\u200d"
            or any(a <= ord(ch) <= b for a, b in _ALPHABETIC_SYMBOLS))


# -- patterns and splits ---------------------------------------------------------


def _find_matches(pattern, text: str) -> List[Tuple[int, int, bool]]:
    """(start, end, is_match) pieces covering `text` (the library's
    Pattern::find_matches): `pattern` a compiled regex, a literal string or
    a predicate on one character."""
    if not text:
        return [(0, 0, False)]
    spans: List[Tuple[int, int]]
    if isinstance(pattern, str):
        spans, start = [], 0
        while pattern:
            at = text.find(pattern, start)
            if at < 0:
                break
            spans.append((at, at + len(pattern)))
            start = at + len(pattern)
    elif callable(pattern):
        spans = [(i, i + 1) for i, ch in enumerate(text) if pattern(ch)]
    else:
        spans = [m.span() for m in pattern.finditer(text)]
    out, prev = [], 0
    for start, end in spans:
        if prev != start:
            out.append((prev, start, False))
        out.append((start, end, True))
        prev = end
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


def _split_spans(text: str, pattern, behavior: str, invert: bool = False) -> List[Tuple[str, int]]:
    """NormalizedString::split: `text` cut at `pattern`'s matches by
    `behavior` (removed, isolated, merged_with_previous, merged_with_next,
    contiguous); empty pieces dropped. → [(piece, its start in text)]."""
    matches = [(a, b, m != invert) for a, b, m in _find_matches(pattern, text)]
    behavior = behavior.lower().replace("mergedwith", "merged_with_")
    if behavior == "isolated":
        pieces = [(a, b) for a, b, _ in matches]
    elif behavior == "removed":
        pieces = [(a, b) for a, b, m in matches if not m]
    elif behavior in ("contiguous", "merged_with_previous"):
        pieces, previous = [], False
        for a, b, m in matches:
            merge = (m == previous) if behavior == "contiguous" else (m and not previous)
            if merge and pieces:
                pieces[-1] = (pieces[-1][0], b)
            else:
                pieces.append((a, b))
            previous = m
    elif behavior == "merged_with_next":
        pieces, previous = [], False
        for a, b, m in reversed(matches):
            if m and not previous and pieces:
                pieces[-1] = (a, pieces[-1][1])
            else:
                pieces.append((a, b))
            previous = m
        pieces.reverse()
    else:
        raise UnsupportedTokenizer(f"unsupported split behavior {behavior!r}")
    return [(text[a:b], a) for a, b in pieces if b > a]


def _pattern(spec) -> object:
    if "Regex" in spec:
        return compile_onig(spec["Regex"])
    if "String" in spec:
        return spec["String"]
    raise UnsupportedTokenizer(f"unsupported pattern {spec!r}")


# -- normalizers and pre-tokenizers: str -> str, str -> [str] -------------------------


def _normalizer(spec) -> Optional[Callable[[str], str]]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind in ("NFC", "NFKC"):
        return lambda text: unicodedata.normalize(kind, text)
    if kind == "Prepend":
        prepend = spec["prepend"]
        return lambda text: prepend + text if text else text
    if kind == "Replace":
        return _replace(spec)
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]
        steps = [s for s in steps if s is not None]

        def run(text: str) -> str:
            for step in steps:
                text = step(text)
            return text

        return run
    raise _unsupported("normalizer", spec)


def _replace(spec) -> Callable[[str], str]:
    """Every match of the pattern (a string, or a regex) replaced by the
    content."""
    pattern, content = _pattern(spec["pattern"]), spec["content"]
    if isinstance(pattern, str):
        return lambda text: text.replace(pattern, content) if pattern else text
    return lambda text: pattern.sub(lambda _m: content, text)


def _byte_level_map(piece: str) -> str:
    return "".join(BYTES_CHAR[b] for b in piece.encode("utf-8"))


# a pre-tokenizer step: (piece, does it start the input?) → such pieces
Piece = Tuple[str, bool]


def _split_step(pattern, behavior: str, invert: bool = False) -> Callable[[str, bool], List[Piece]]:
    def run(piece: str, at_start: bool) -> List[Piece]:
        return [(p, at_start and a == 0) for p, a in _split_spans(piece, pattern, behavior, invert)]

    return run


def _metaspace(spec) -> Callable[[str, bool], List[Piece]]:
    """The library's Metaspace: spaces → the replacement, the replacement
    prepended by the scheme (``first``: only to the piece that starts the
    input), then (``split``) a cut before every replacement."""
    rep = spec["replacement"]
    scheme = spec.get("prepend_scheme")
    if scheme is None:  # the older field
        scheme = "always" if spec.get("add_prefix_space", True) else "never"
    if scheme not in ("always", "first", "never"):
        raise UnsupportedTokenizer(f"unsupported Metaspace prepend_scheme {scheme!r}")
    split = bool(spec.get("split", True))

    def run(piece: str, at_start: bool) -> List[Piece]:
        piece = piece.replace(" ", rep)
        if not piece.startswith(rep) and (scheme == "always" or (scheme == "first" and at_start)):
            piece = rep + piece
        if not split:
            return [(piece, at_start)]
        return [(p, at_start and a == 0) for p, a in _split_spans(piece, rep, "merged_with_next")]

    return run


def _pre_tokenizer(spec) -> List[Callable[[str, bool], List[Piece]]]:
    """A pre-tokenizer → its steps, each one piece → pieces."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [step for s in spec["pretokenizers"] for step in _pre_tokenizer(s)]
    if kind == "Split":
        return [_split_step(_pattern(spec["pattern"]), spec["behavior"], bool(spec.get("invert")))]
    if kind == "Digits":
        behavior = "isolated" if spec.get("individual_digits") else "contiguous"
        return [_split_step(lambda ch: category(ch)[0] == "N", behavior)]
    if kind == "Metaspace":
        return [_metaspace(spec)]
    if kind == "ByteLevel":
        prefix, regex = bool(spec.get("add_prefix_space")), spec.get("use_regex", True)
        gpt2 = compile_onig(GPT2_PATTERN) if regex else None

        def split(piece: str, at_start: bool) -> List[Piece]:
            if prefix and not piece.startswith(" "):
                piece = " " + piece
            if not regex:
                return [(piece, at_start)]
            return [(p, at_start and a == 0) for p, a in _split_spans(piece, gpt2, "isolated")]

        # the byte mapping runs after every piece was split
        return [split, lambda piece, at_start: [(_byte_level_map(piece), at_start)]]
    raise _unsupported("pre-tokenizer", spec)


# -- decoders: [str] -> [str] -----------------------------------------------------------


def _byte_level_decode(tokens: List[str]) -> List[str]:
    raw = bytearray()
    for token in tokens:
        mapped = [CHAR_BYTES.get(ch) for ch in token]
        raw += bytes(mapped) if None not in mapped else token.encode("utf-8")
    return [raw.decode("utf-8", "replace")]


def _byte_fallback_decode(tokens: List[str]) -> List[str]:
    out: List[str] = []
    pending = bytearray()

    def flush() -> None:
        if pending:
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" * len(pending))
            pending.clear()

    for token in tokens:
        byte = None
        if len(token) == 6 and token.startswith("<0x") and token.endswith(">"):
            try:
                byte = int(token[3:5], 16)
            except ValueError:
                byte = None
        if byte is not None:
            pending.append(byte)
        else:
            flush()
            out.append(token)
    flush()
    return out


def _strip_decode(content: str, start: int, stop: int) -> Callable[[List[str]], List[str]]:
    def run(tokens: List[str]) -> List[str]:
        out = []
        for token in tokens:
            chars = list(token)
            cut = 0
            for ch in chars[:start]:
                if ch != content:
                    break
                cut += 1
            end = len(chars)
            for i in range(min(stop, len(chars))):
                if chars[len(chars) - i - 1] != content:
                    break
                end = len(chars) - i - 1
            out.append("".join(chars[cut:max(cut, end)]))
        return out

    return run


def _decoder(spec) -> Optional[Callable[[List[str]], List[str]]]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "ByteFallback":
        return _byte_fallback_decode
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        return _strip_decode(spec["content"], int(spec.get("start", 0)), int(spec.get("stop", 0)))
    if kind == "Replace":
        pattern, content = _pattern(spec["pattern"]), spec["content"]
        if isinstance(pattern, str):
            return lambda tokens: [t.replace(pattern, content) for t in tokens]
        return lambda tokens: [pattern.sub(lambda _m: content, t) for t in tokens]
    if kind == "Metaspace":
        rep = spec["replacement"]
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"

        def metaspace(tokens: List[str]) -> List[str]:
            # the library drops every replacement of the first token, not
            # only a leading one, unless the scheme is never
            return [t.replace(rep, "" if i == 0 and scheme != "never" else " ")
                    for i, t in enumerate(tokens)]

        return metaspace
    if kind == "Sequence":
        steps = [_decoder(s) for s in spec["decoders"]]

        def run(tokens: List[str]) -> List[str]:
            for step in steps:
                tokens = step(tokens)
            return tokens

        return run
    raise _unsupported("decoder", spec)


# -- the BPE model ------------------------------------------------------------------------


class BpeModel:
    def __init__(self, spec: dict):
        if spec.get("type", "BPE") != "BPE":
            raise _unsupported("model", spec)
        if spec.get("dropout") not in (None, 0.0):
            raise UnsupportedTokenizer(f"unsupported BPE dropout {spec['dropout']!r} (sampled merges)")
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk"))
        self.byte_fallback = bool(spec.get("byte_fallback"))
        self.ignore_merges = bool(spec.get("ignore_merges"))
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, merge in enumerate(spec["merges"]):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            new = a + (b[len(self.prefix):] if self.prefix and b.startswith(self.prefix) else b)
            try:
                self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[new])
            except KeyError as err:
                raise UnsupportedTokenizer(f"merge {a!r} {b!r}: {err.args[0]!r} is not in the vocabulary")
        self._cache: Dict[str, List[int]] = {}

    def _symbols(self, word: str) -> List[int]:
        """The word's characters as ids (with prefix/suffix, byte fallback
        and unk as the library's merge_word does)."""
        ids: List[int] = []
        unk: Optional[int] = None  # a pending (possibly fused) unk
        for i, ch in enumerate(word):
            s = (self.prefix if i > 0 else "") + ch + (self.suffix if i == len(word) - 1 else "")
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(tid)
                continue
            if self.byte_fallback:
                codes = [self.vocab.get(f"<0x{b:02X}>") for b in s.encode("utf-8")]
                if None not in codes:
                    ids.extend(codes)
                    continue
            if self.unk_token is not None:
                unk_id = self.vocab.get(self.unk_token)
                if unk_id is None:
                    raise UnsupportedTokenizer(f"unk_token {self.unk_token!r} is not in the vocabulary")
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = unk_id
        if unk is not None:
            ids.append(unk)
        return ids

    def tokenize(self, word: str) -> List[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        symbols = self._symbols(word)
        merges = self.merges
        while len(symbols) > 1:
            best, at = None, -1
            for i in range(len(symbols) - 1):
                got = merges.get((symbols[i], symbols[i + 1]))
                if got is not None and (best is None or got[0] < best[0]):
                    best, at = got, i
            if best is None:
                break
            symbols[at:at + 2] = [best[1]]
        if len(self._cache) < 10000:
            self._cache[word] = symbols
        return symbols


# -- the tokenizer ---------------------------------------------------------------------------


class _AddedToken:
    def __init__(self, spec: dict):
        self.id = int(spec["id"])
        self.content = spec["content"]
        self.special = bool(spec.get("special"))
        self.lstrip = bool(spec.get("lstrip"))
        self.rstrip = bool(spec.get("rstrip"))
        self.single_word = bool(spec.get("single_word"))
        self.normalized = bool(spec.get("normalized", not self.special))


class TokenizerAdapter:
    """The reference adapter's surface over a parsed tokenizer.json."""

    def __init__(self, spec: dict):
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise UnsupportedTokenizer(f"unsupported {key} {spec[key]!r}")
        self.model = BpeModel(spec["model"])
        self.normalizer = _normalizer(spec.get("normalizer"))
        self.pre_tokenizer = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.decoder = _decoder(spec.get("decoder"))
        self.added = [_AddedToken(t) for t in spec.get("added_tokens") or []]
        self._assign_added_ids()
        self.added_by_id = {t.id: t for t in self.added}
        self.added_by_content = {t.content: t for t in self.added}
        self.special = {t.content for t in self.added if t.special}
        self._raw_re = self._alternation([t for t in self.added if not t.normalized], False)
        self._norm_re = self._alternation([t for t in self.added if t.normalized], True)

    def _assign_added_ids(self) -> None:
        """Added tokens' ids as the library assigns them on loading (the
        file's "id" is not read): the vocabulary's id of the same string,
        else the one before, else the next after the largest added id, or
        the vocabulary's size if that is larger."""
        vocab, size = self.model.vocab, len(self.model.vocab)
        given: Dict[str, int] = {}
        for token in self.added:
            if token.content in vocab:
                token.id = vocab[token.content]
            elif token.content in given:
                token.id = given[token.content]
            else:
                top = max(given.values(), default=None)
                token.id = top + 1 if top is not None and top >= size else size
            given[token.content] = token.id

    def _alternation(self, tokens: List[_AddedToken], normalized: bool):
        """Leftmost-longest matching of `tokens` (the library's
        Aho-Corasick): literals, longest first. → (regex, {text: token})."""
        by_text = {}
        for t in tokens:
            text = self.normalizer(t.content) if normalized and self.normalizer else t.content
            by_text.setdefault(text, t)
        texts = sorted((t for t in by_text if t), key=len, reverse=True)
        return (re.compile("|".join(map(re.escape, texts))), by_text) if texts else None

    @staticmethod
    def _find_added(text: str, matcher) -> List[Tuple[str, Optional[int]]]:
        """`text` cut at its added tokens → [(piece, id or None)] (the
        library's AddedVocabulary::find_matches)."""
        if matcher is None or not text:
            return [(text, None)]
        regex, by_text = matcher
        out: List[Tuple[str, Optional[int]]] = []
        offset = 0
        for m in regex.finditer(text):
            start, stop = m.span()
            token = by_text[m.group()]
            if token.single_word:
                if (start > 0 and _is_word_char(text[start - 1])) or (
                        stop < len(text) and _is_word_char(text[stop])):
                    continue
            if token.lstrip:
                new_start = start
                while new_start > 0 and text[new_start - 1] in _WHITE_SPACE:
                    new_start -= 1
                start = max(new_start, offset)
            if token.rstrip:
                while stop < len(text) and text[stop] in _WHITE_SPACE:
                    stop += 1
            if offset < start:
                out.append((text[offset:start], None))
            out.append((text[start:stop], token.id))
            offset = stop
        if offset != len(text):
            out.append((text[offset:], None))
        return out

    def encode(self, text: str) -> List[int]:
        """Ids of `text` without special tokens added around it. Each piece
        carries whether it starts the input (what Metaspace's ``first``
        scheme reads)."""
        ids: List[int] = []
        at = 0
        for raw, tid in self._find_added(text, self._raw_re):
            raw_start, at = at == 0, at + len(raw)
            if tid is not None:
                ids.append(tid)
                continue
            if self.normalizer is not None:
                raw = self.normalizer(raw)
            norm_at = 0
            for piece, tid2 in self._find_added(raw, self._norm_re):
                piece_start, norm_at = raw_start and norm_at == 0, norm_at + len(piece)
                if tid2 is not None:
                    ids.append(tid2)
                    continue
                pieces = [(piece, piece_start)] if piece else []
                for step in self.pre_tokenizer:
                    pieces = [p for q in pieces for p in step(*q) if p[0]]
                for p, _ in pieces:
                    ids.extend(self.model.tokenize(p))
        return ids

    def id_to_token(self, tid: int) -> Optional[str]:
        added = self.added_by_id.get(tid)
        return added.content if added is not None else self.model.id_to_token.get(tid)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for tid in ids:
            token = self.id_to_token(int(tid))
            if token is None or (skip_special_tokens and token in self.special):
                continue
            tokens.append(token)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))

    def token_to_id(self, token: str) -> Optional[int]:
        added = self.added_by_content.get(token)
        return added.id if added is not None else self.model.vocab.get(token)

    @property
    def vocab_size(self) -> int:
        return len(set(self.model.vocab.values()) | set(self.added_by_id))


def load_tokenizer(path) -> TokenizerAdapter:
    """Parse a tokenizer.json."""
    return TokenizerAdapter(json.loads(pathlib.Path(path).read_text(encoding="utf-8")))
