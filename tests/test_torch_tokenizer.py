"""The port's CLIP tokenizer against the JAX package's, token for token.

The JAX package splits text with the ``regex`` module; the port compiles
the same split for the standard ``re`` (``utils.tokenizer``). These run on
the CPU: a corpus through ``encode``, the pre-token split and the
whitespace clean of every BMP code point in several contexts, ``tokenize``'s
padding, truncation and error, ``decode``, and the port's tokenizer in a
process where ``regex``, ``ftfy`` and JAX cannot be imported.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from enhancing_tpu.utils import tokenizer as jax_tokenizer
from enhancing_tpu_torch.utils import tokenizer as port_tokenizer

REPO = Path(__file__).resolve().parents[1]

CORPUS = [
    "A photo of a cat sitting on a mat.",
    "Two dogs, 3 cats and 1,024 birds in 2019!",
    "It's what they've said: we'll see, I'd think, you're right, I'm sure,"
    " don't.",
    "IT'S LOUD &amp; CLEAR &lt;b&gt;bold&lt;/b&gt; &#39;quoted&#39; &amp;amp;",
    "CafÃ© au lait, naÃ¯ve faÃ§ade, Ã©tÃ©",
    "Café crème brûlée, façade, naïve, ÉTÉ",
    "Cafe\u0301 cre\u0300me bru\u0302le\u0301e",
    "東京タワーの夜景 北京の街 서울의 밤",
    "a 🐱 and a 🐶, 👍🏽 🇫🇷 ❤️",
    "x² + y² = z², ½ cup, Ⅻ o'clock, ³⁄₄ inch, ⅷ",
    "tabs\tand\nnewlines\u00a0nbsp\u2003em\x1cfs\x1f",
    "<|startoftext|>hello world<|endoftext|>",
    "ſtraße ΣΊΣΥΦΟΣ ǅemal ﬁne İstanbul it'ſ",
    "don't<|endoftext|>!'s ''re",
    "The quick brown fox jumps over the lazy dog " * 6,
    "   ",
    "",
]
CONTEXTS = ("a{}1", "ab{}12", "1{}'s", "{}{}", " {} ", "{}<|endoftext|>")


@pytest.fixture(scope="module")
def tokenizers():
    return jax_tokenizer.SimpleTokenizer(), port_tokenizer.SimpleTokenizer()


@pytest.mark.parametrize("text", CORPUS)
def test_encode_matches_jax(tokenizers, text):
    jax_tok, port_tok = tokenizers
    assert port_tok.encode(text) == jax_tok.encode(text)


def _every_bmp(context: str, start: int) -> str:
    return "".join(context.replace("{}", chr(c))
                   for c in range(start, min(start + 4096, 0x10000)))


@pytest.mark.parametrize("context", CONTEXTS)
def test_split_of_every_bmp_code_point_matches_regex(tokenizers, context):
    """Each BMP code point (surrogates included) between letters, digits,
    contractions and special tokens: the port's ``re`` split equals the
    ``regex`` split of the JAX tokenizer, as is and lowercased."""
    jax_tok, port_tok = tokenizers
    for start in range(0, 0x10000, 4096):
        text = _every_bmp(context, start)
        for t in (text, text.lower()):
            assert port_tok.pat.findall(t) == jax_tok.pat.findall(t), \
                f"block U+{start:04X} in context {context!r}"


@pytest.mark.parametrize("context", CONTEXTS[:2])
def test_whitespace_clean_of_every_bmp_code_point(context):
    for start in range(0, 0x10000, 4096):
        text = _every_bmp(context, start)
        assert port_tokenizer.whitespace_clean(text) == \
            jax_tokenizer.whitespace_clean(text), f"block U+{start:04X}"


def test_basic_clean_matches_jax():
    for text in CORPUS:
        assert port_tokenizer.basic_clean(text) == \
            jax_tokenizer.basic_clean(text)


def test_tokenize_pads_truncates_and_raises(tokenizers):
    jax_tok, port_tok = tokenizers
    for length in (4, 16, 77):
        np.testing.assert_array_equal(port_tok.tokenize(CORPUS, length),
                                      jax_tok.tokenize(CORPUS, length))
    got = port_tok.tokenize(CORPUS[0])
    assert got.shape == (port_tok.context_length,) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_tok.tokenize(CORPUS[0]))
    messages = []
    for tok in (jax_tok, port_tok):
        with pytest.raises(RuntimeError) as err:
            tok.tokenize(CORPUS, 4, truncate_text=False)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_decode_matches_jax(tokenizers):
    jax_tok, port_tok = tokenizers
    for row in jax_tok.tokenize(CORPUS, 77):
        assert port_tok.decode(row) == jax_tok.decode(row)
    ids = np.random.default_rng(0).integers(0, jax_tok.vocab_size + 10,
                                            (4, 20))
    for row in ids:
        assert port_tok.decode(row) == jax_tok.decode(row)
    assert port_tok.vocab_size == jax_tok.vocab_size == 49408


def test_port_tokenizer_needs_no_regex(tokenizers):
    """In a process where ``regex``, ``ftfy``, JAX and the JAX package
    cannot be imported, the port's tokenizer (and the conditioners,
    datasets and loaders beside it) import and encode as JAX does."""
    code = (
        "import json, sys\n"
        "for name in ('regex', 'ftfy', 'jax', 'enhancing_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import enhancing_tpu_torch.models.cond, enhancing_tpu_torch.data\n"
        "import enhancing_tpu_torch.compat\n"
        "from enhancing_tpu_torch.utils.tokenizer import SimpleTokenizer\n"
        "texts = json.loads(sys.stdin.read())\n"
        "print(json.dumps([SimpleTokenizer().encode(t) for t in texts]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         input=json.dumps(CORPUS), capture_output=True,
                         text=True, check=True, timeout=120)
    jax_tok, _ = tokenizers
    assert json.loads(out.stdout) == [jax_tok.encode(t) for t in CORPUS]
