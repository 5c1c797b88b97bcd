"""The port's tokenizer.json reader (dsocr_tpu_torch/utils/tokenizer.py)
against the Rust ``tokenizers`` library on the same files: ids without
special tokens, decode with and without skip_special_tokens (every
prefix of a sequence: the streaming case; ids outside the vocabulary),
token_to_id; what the reader does not implement raises by name."""

import json

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

tokenizers = pytest.importorskip("tokenizers")
from tokenizers import AddedToken, Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, trainers  # noqa: E402

from dsocr_tpu_torch.utils import onig_regex  # noqa: E402
from dsocr_tpu_torch.utils.tokenizer import UnsupportedTokenizer, _is_word_char, load_tokenizer  # noqa: E402

# DeepSeek's pre-tokenizer regexes (the V2/V3 tokenizer.json): digits in
# runs of up to three, CJK runs, then letters/marks, punctuation/symbols
# and whitespace by Unicode property classes
DIGITS_RE = r"\p{N}{1,3}"
CJK_RE = "[一-龥぀-ゟ゠-ヿ]+"
WORDS_RE = (r"[!\"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~][A-Za-z]+|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+"
            r"| ?[\p{P}\p{S}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
SPECIALS = ["<｜begin▁of▁sentence｜>", "<｜end▁of▁sentence｜>", "<image>", "<|ref|>", "<|/ref|>"]

CORPUS_PARTS = [
    "The quick brown fox jumps over the lazy dog. ", "Invoice #12345 total: $6,789.01\r\n",
    "东京都の天気は晴れです。", "北京欢迎你，今天是2024年10月18日。", "한국어 텍스트도 있습니다. ",
    "naïve café résumé — déjà vu; Ångström. ", "é ä ô combining marks ",
    "emoji 😀🎉👍🏽 and 👨‍👩‍👧 families ", "Ελληνικά και русский текст. ", "tabs\tand  spaces   \n\n",
    "<table><tr><td>cell</td></tr></table> ", "x = f(y) + 3.14159 * z**2 ", "مرحبا بالعالم ",
]
FIXED = [
    "", " ", "Hello, world!", "  leading and trailing  ", "1234567890 123 45", "line1\r\nline2\n\n\nline3",
    "东京都の天気は晴れです。北京欢迎你", "naïve café", "é̂x", "😀🎉👍🏽 👨‍👩‍👧", "<image>\nFree OCR.",
    "a<image>b <image> c", "<｜end▁of▁sentence｜>done", "tab\there", " nbsp em　ideo",
    "\x1c\x1d\x1e\x1f info separators", "¡¿?! --- ...", "x" * 300, "Ǆǅǆ ǈ ﬁ ß ẞ", "<|ref|>title<|/ref|>",
    "𝔘𝔫𝔦𝔠𝔬𝔡𝔢 𝟙𝟚𝟛", "٣٤٥ ١٢", "Ⅻ ½ ² ⑩", "mixed123abc456",
]


def corpus():
    rng = np.random.default_rng(0)
    for _ in range(400):
        picks = rng.integers(0, len(CORPUS_PARTS), size=6)
        yield "".join(CORPUS_PARTS[i] for i in picks)


def _deepseek_shaped(tmp_path, vocab_size=600):
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(DIGITS_RE), behavior="isolated"),
        pre_tokenizers.Split(Regex(CJK_RE), behavior="isolated"),
        pre_tokenizers.Split(Regex(WORDS_RE), behavior="isolated"),
        pre_tokenizers.Digits(individual_digits=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=SPECIALS[:3],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False)
    tok.train_from_iterator(corpus(), trainer)
    tok.add_special_tokens(SPECIALS[3:])
    tok.add_tokens([AddedToken("[[mark]]", single_word=True, lstrip=True, rstrip=True, normalized=False),
                    AddedToken("ocr", normalized=True)])
    path = tmp_path / "tokenizer.json"
    tok.save(str(path))
    return tok, path


def _gpt2_shaped(tmp_path):
    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True, use_regex=True)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=500, special_tokens=["<|endoftext|>", "<image>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False)
    tok.train_from_iterator(corpus(), trainer)
    path = tmp_path / "gpt2.json"
    tok.save(str(path))
    return tok, path


def _char_level(tmp_path, **bpe):
    """A char-level BPE with byte fallback, unk, a continuing-subword
    prefix and an end-of-word suffix (no ByteLevel), decoded by
    ByteFallback + Strip + Replace + Fuse."""
    chars = sorted(set("abcdefghijklmnop qrstuvwxyz"))
    prefix, suffix = bpe.get("continuing_subword_prefix") or "", bpe.get("end_of_word_suffix") or ""
    vocab = {"<unk>": 0}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for c in chars:
        for form in {c, prefix + c, c + suffix, prefix + c + suffix}:
            vocab.setdefault(form, len(vocab))
    merges = []
    for a, b in [("t", "h"), ("th", "e"), ("a", "n"), ("an", "d"), ("i", "n"), ("in", "g"), ("e", "r")]:
        left, right = a, prefix + b
        merges.append((left, right))
        vocab.setdefault(left + right[len(prefix):], len(vocab))
    tok = Tokenizer(models.BPE(vocab, merges, unk_token="<unk>", **bpe))
    tok.normalizer = normalizers.Sequence([normalizers.NFKC()])
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(" ", behavior="merged_with_next"), pre_tokenizers.Digits(individual_digits=True)])
    tok.decoder = decoders.Sequence([decoders.ByteFallback(), decoders.Strip(" ", 0, 1),
                                     decoders.Replace("q", "Q"), decoders.Fuse()])
    path = tmp_path / "char.json"
    tok.save(str(path))
    return tok, path


@pytest.fixture(scope="module")
def deepseek(tmp_path_factory):
    tok, path = _deepseek_shaped(tmp_path_factory.mktemp("tok"))
    return tok, load_tokenizer(path)


@pytest.fixture(scope="module")
def gpt2(tmp_path_factory):
    tok, path = _gpt2_shaped(tmp_path_factory.mktemp("gpt2"))
    return tok, load_tokenizer(path)


def _same_encode(ref, mine, text):
    assert mine.encode(text) == ref.encode(text, add_special_tokens=False).ids, repr(text)


def _same_decode(ref, mine, ids):
    for skip in (True, False):
        assert mine.decode(ids, skip_special_tokens=skip) == ref.decode(ids, skip_special_tokens=skip), (ids, skip)


@pytest.mark.parametrize("shape", ["deepseek", "gpt2"])
def test_encode_fixed_strings(shape, request):
    ref, mine = request.getfixturevalue(shape)
    for text in FIXED + CORPUS_PARTS:
        _same_encode(ref, mine, text)
        _same_encode(ref, mine, text + " " + text)


@pytest.mark.parametrize("shape", ["deepseek", "gpt2"])
def test_decode_every_prefix(shape, request):
    """The scheduler decodes the whole list at each chunk boundary: every
    prefix, split CJK and emoji bytes included, decodes as the library's
    (U+FFFD where a character is cut)."""
    ref, mine = request.getfixturevalue(shape)
    text = "".join(FIXED[6:12]) + "<image>" + CORPUS_PARTS[7]
    ids = ref.encode(text, add_special_tokens=False).ids
    assert any("�" in ref.decode(ids[:n]) for n in range(len(ids)))  # a cut character shows
    for n in range(len(ids) + 1):
        _same_decode(ref, mine, ids[:n])


@pytest.mark.parametrize("shape", ["deepseek", "gpt2"])
def test_decode_random_ids_and_out_of_vocabulary(shape, request):
    ref, mine = request.getfixturevalue(shape)
    size = ref.get_vocab_size(with_added_tokens=True)
    rng = np.random.default_rng(1)
    for _ in range(50):
        ids = rng.integers(0, size + 40, size=int(rng.integers(0, 30))).tolist()
        _same_decode(ref, mine, ids)
    _same_decode(ref, mine, [size + 5, 0, size + 100, 1, 2])  # outside the vocabulary: skipped
    assert mine.decode([size + 7]) == ref.decode([size + 7]) == ""


@pytest.mark.parametrize("shape", ["deepseek", "gpt2"])
def test_token_to_id(shape, request):
    ref, mine = request.getfixturevalue(shape)
    names = list(ref.get_vocab(with_added_tokens=True))[:300] + SPECIALS + ["[[mark]]", "ocr", "nope", ""]
    for name in names:
        assert mine.token_to_id(name) == ref.token_to_id(name), name
    if shape == "deepseek":
        assert mine.token_to_id("<image>") is not None


@settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text(max_size=40))
def test_encode_decode_hypothesis_deepseek(deepseek, text):
    ref, mine = deepseek
    _same_encode(ref, mine, text)
    _same_decode(ref, mine, ref.encode(text, add_special_tokens=False).ids)


@settings(max_examples=80, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.lists(st.sampled_from(list(" \t\n\r\u3000abcXYZ019\u0663e\u0301\u6771\U0001F600<>[]!?.,-_")
                                     + ["<image>", "[[mark]]", "ocr", "<|ref|>"]), max_size=30).map("".join))
def test_added_tokens_hypothesis(deepseek, text):
    """Added tokens among spaces, words and punctuation: single_word,
    lstrip, rstrip, normalized and special tokens as the library cuts them."""
    ref, mine = deepseek
    _same_encode(ref, mine, text)


@settings(max_examples=80, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text(max_size=40))
def test_encode_hypothesis_gpt2(gpt2, text):
    ref, mine = gpt2
    _same_encode(ref, mine, text)


@pytest.mark.parametrize("bpe", [
    dict(byte_fallback=True),
    dict(fuse_unk=True),
    dict(fuse_unk=False),
    dict(byte_fallback=True, continuing_subword_prefix="##"),
    dict(end_of_word_suffix="</w>", fuse_unk=True),
    dict(ignore_merges=True, byte_fallback=True),
], ids=["byte_fallback", "fuse_unk", "unk", "prefix", "suffix", "ignore_merges"])
def test_bpe_options(tmp_path, bpe):
    ref, path = _char_level(tmp_path, **bpe)
    mine = load_tokenizer(path)
    texts = ["the thing and ring", "THE ÄÖÜ", "x1y22z", "αβγ the", "  in  ", "qqq", "ﬁnd", ""]
    for text in texts:
        _same_encode(ref, mine, text)
        _same_decode(ref, mine, ref.encode(text, add_special_tokens=False).ids)
    _same_decode(ref, mine, list(range(0, 300, 7)) + [10 ** 6])


@pytest.mark.parametrize("behavior", ["removed", "isolated", "merged_with_previous", "merged_with_next",
                                      "contiguous"])
@pytest.mark.parametrize("invert", [False, True])
def test_split_behaviors(tmp_path, behavior, invert):
    tok = Tokenizer(models.BPE({c: i for i, c in enumerate(sorted(set(pre_tokenizers.ByteLevel.alphabet())))},
                               []))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(r"\p{P}+|\s"), behavior=behavior, invert=invert),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.save(str(tmp_path / "t.json"))
    mine = load_tokenizer(tmp_path / "t.json")
    for text in ["a, b!! c", "!!x", "x!!", "  ", "a b  c...", "", "。、！"]:
        assert mine.encode(text) == tok.encode(text, add_special_tokens=False).ids, text


# every code point of planes 0-3 and 14 (planes 4-13, 15 and 16 hold only
# unassigned and private-use code points, one category each)
ALL_ASSIGNED_PLANES = "".join(chr(c) for c in [*range(0x40000), *range(0xE0000, 0xE1000)]
                              if not 0xD800 <= c <= 0xDFFF)


def test_property_classes_match_oniguruma_over_every_code_point():
    """The translated \\p{..}, \\s and \\d classes take the same code points
    as the library's Oniguruma (Unicode 16.0 tables)."""
    chars = ALL_ASSIGNED_PLANES
    for rx in [r"\p{L}", r"\p{N}", r"\p{P}", r"\p{S}", r"\p{M}", r"\p{Lu}", r"\s", r"\d", r"\P{L}",
               r"[^\s\p{L}\p{N}]"]:
        removed = pre_tokenizers.Split(Regex(rx), behavior="removed")
        kept = "".join(p for p, _ in removed.pre_tokenize_str(chars))
        mine = "".join(onig_regex.compile_onig(rx).split(chars))
        assert mine == kept, rx


def _spec(path):
    return json.loads(path.read_text())


@pytest.mark.parametrize("where, value, name", [
    ("normalizer", {"type": "Lowercase"}, "Lowercase"),
    ("pre_tokenizer", {"type": "Whitespace"}, "Whitespace"),
    ("decoder", {"type": "WordPiece", "prefix": "##", "cleanup": True}, "WordPiece"),
    ("model", {"type": "WordPiece", "vocab": {"a": 0}, "unk_token": "a"}, "WordPiece"),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": "(?i:'s|'t)"}, "behavior": "Isolated",
                       "invert": False}, "(?i"),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\w+"}, "behavior": "Isolated",
                       "invert": False}, r"\w"),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"^\s+"}, "behavior": "Isolated",
                       "invert": False}, "anchor ^"),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\p{N}{1,3}+"}, "behavior": "Isolated",
                       "invert": False}, "{n,m}+"),
    ("truncation", {"max_length": 8}, "truncation"),
])
def test_unsupported_components_raise_by_name(tmp_path, gpt2, where, value, name):
    _, path = _gpt2_shaped(tmp_path)
    spec = _spec(path)
    if where == "model":
        spec["model"] = value
    else:
        spec[where] = value
    path.write_text(json.dumps(spec))
    with pytest.raises(ValueError, match=__import__("re").escape(name)):
        load_tokenizer(path)


def test_bpe_dropout_raises(tmp_path):
    _, path = _gpt2_shaped(tmp_path)
    spec = _spec(path)
    spec["model"]["dropout"] = 0.1
    path.write_text(json.dumps(spec))
    with pytest.raises(UnsupportedTokenizer, match="dropout"):
        load_tokenizer(path)


def test_added_token_ids_as_the_library_assigns_them(tmp_path):
    """The library ignores an added token's "id" on loading: the
    vocabulary's id of the same string, else the next id past the
    vocabulary and the added tokens before it."""
    _, path = _gpt2_shaped(tmp_path)
    spec = _spec(path)
    vocab = spec["model"]["vocab"]
    inside = next(iter(vocab))
    spec["added_tokens"] += [
        {"id": 3, "content": "<late>", "single_word": False, "lstrip": False, "rstrip": False, "normalized": False,
         "special": True},
        {"id": 7, "content": inside, "single_word": False, "lstrip": False, "rstrip": False, "normalized": False,
         "special": True}]
    path.write_text(json.dumps(spec))
    ref, mine = Tokenizer.from_file(str(path)), load_tokenizer(path)
    for name in ("<late>", inside, "<image>", "<|endoftext|>"):
        assert mine.token_to_id(name) == ref.token_to_id(name), name
    ids = list(range(len(vocab) + 5))
    _same_decode(ref, mine, ids)
    _same_encode(ref, mine, f"a<late>b {inside}<image>")


def test_single_word_neighbours_over_every_code_point(tmp_path):
    """Which characters beside a single_word added token keep it from
    matching: the same set as the library's, over all of Unicode."""
    tok = Tokenizer(models.BPE({"a": 0}, []))
    tok.add_tokens([AddedToken("QQ", single_word=True)])
    tok.save(str(tmp_path / "sw.json"))
    mine = load_tokenizer(tmp_path / "sw.json")
    qid = tok.token_to_id("QQ")
    chars = list(ALL_ASSIGNED_PLANES)
    for texts in ([c + "QQ" for c in chars], ["QQ" + c for c in chars]):
        ref = [qid not in e.ids for e in tok.encode_batch(texts, add_special_tokens=False)]
        assert [_is_word_char(c) for c in chars] == ref
    for text in ("éQQ", "QQ_", "Ⓐ QQ", "x\u200dQQ", "😀QQ😀", "1QQ", "١QQ"):
        _same_encode(tok, mine, text)


# -- SentencePiece-converted shapes (PaddleOCR-VL's ERNIE tokenizer) -------------------------

SP_SPECIALS = ["<unk>", "<s>", "</s>", "<|IMAGE_START|>", "<|IMAGE_END|>"]
BYTES = [f"<0x{b:02X}>" for b in range(256)]


def _sentencepiece_metaspace(tmp_path, scheme="always", split=True):
    """tokenizers' SentencePieceBPETokenizer (NFKC, Metaspace pre-tokenizer
    and decoder), trained with the byte tokens so that BPE falls back to
    bytes, with the scheme and split under test and special tokens
    added."""
    sp = tokenizers.SentencePieceBPETokenizer(unk_token="<unk>", fuse_unk=True)
    sp.train_from_iterator(corpus(), vocab_size=700, special_tokens=SP_SPECIALS + BYTES, show_progress=False)
    spec = json.loads(sp._tokenizer.to_str())
    spec["model"]["byte_fallback"] = True
    for key in ("pre_tokenizer", "decoder"):
        spec[key].update(prepend_scheme=scheme, split=split)
    tok = Tokenizer.from_str(json.dumps(spec))
    tok.add_tokens([AddedToken("ocr", normalized=True)])
    path = tmp_path / f"sp_{scheme}_{split}.json"
    tok.save(str(path))
    return tok, path


def _sentencepiece_converted(tmp_path):
    """The shape transformers' slow-to-fast conversion gives a SentencePiece
    BPE: Prepend("▁") + Replace(" ", "▁") normalizers, no pre-tokenizer,
    byte fallback, decoded by Replace + ByteFallback + Fuse + Strip."""
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
                                     decoders.Strip(" ", 1, 0)])
    trainer = trainers.BpeTrainer(vocab_size=700, special_tokens=SP_SPECIALS + BYTES, show_progress=False)
    tok.train_from_iterator(corpus(), trainer)
    path = tmp_path / "sp_converted.json"
    tok.save(str(path))
    return tok, path


@pytest.fixture(scope="module")
def sentencepiece(tmp_path_factory):
    out = {}
    for scheme in ("always", "first", "never"):
        for split in (True, False):
            tok, path = _sentencepiece_metaspace(tmp_path_factory.mktemp("sp"), scheme, split)
            out[f"metaspace_{scheme}_{split}"] = (tok, load_tokenizer(path))
    tok, path = _sentencepiece_converted(tmp_path_factory.mktemp("spc"))
    out["converted"] = (tok, load_tokenizer(path))
    return out


SP_SHAPES = [f"metaspace_{s}_{p}" for s in ("always", "first", "never") for p in (True, False)] + ["converted"]
SP_FIXED = FIXED + ["<|IMAGE_END|>", "a <|IMAGE_START|> b<|IMAGE_END|>c", "▁already▁marked", "ocr ocr",
                    "  ", "\u0000\u0007 control", "x<|IMAGE_END|> ocr"]


@pytest.mark.parametrize("shape", SP_SHAPES)
def test_sentencepiece_shapes_encode_and_decode(sentencepiece, shape):
    ref, mine = sentencepiece[shape]
    for text in SP_FIXED:
        _same_encode(ref, mine, text)
    ids = [i for text in SP_FIXED for i in ref.encode(text, add_special_tokens=False).ids]
    for n in range(0, len(ids) + 1, 7):
        _same_decode(ref, mine, ids[:n])
    _same_decode(ref, mine, np.random.default_rng(1).integers(0, ref.get_vocab_size() + 5, 300).tolist())
    assert any(ref.id_to_token(i) in BYTES for i in ref.encode("\u0a85 \u16a0", add_special_tokens=False).ids)
    for token in SP_SPECIALS + ["<0x41>", "▁the", "ocr", "nope"]:
        assert mine.token_to_id(token) == ref.token_to_id(token), token


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text(max_size=30), shape=st.sampled_from(SP_SHAPES))
def test_sentencepiece_shapes_hypothesis(sentencepiece, text, shape):
    ref, mine = sentencepiece[shape]
    _same_encode(ref, mine, text)
    ids = ref.encode(text, add_special_tokens=False).ids
    for n in range(len(ids) + 1):
        _same_decode(ref, mine, ids[:n])


@pytest.mark.parametrize("where, value, name", [
    ("pre_tokenizer", {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "sometimes", "split": True},
     "sometimes"),
    ("normalizer", {"type": "Precompiled", "precompiled_charsmap": ""}, "Precompiled"),
    ("normalizer", {"type": "Strip", "strip_left": True, "strip_right": True}, "Strip"),
    ("pre_tokenizer", {"type": "UnicodeScripts"}, "UnicodeScripts"),
])
def test_unsupported_sentencepiece_components_raise_by_name(tmp_path, where, value, name):
    _, path = _sentencepiece_converted(tmp_path)
    spec = _spec(path)
    spec[where] = value
    path.write_text(json.dumps(spec))
    with pytest.raises(UnsupportedTokenizer, match=name):
        load_tokenizer(path)
