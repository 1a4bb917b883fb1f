"""CLIP byte-pair-encoding tokenizer (vocab 49408), standard library only.

The port's copy of ``enhancing_tpu/utils/tokenizer.py``: the byte ->
unicode table, the greedy lowest-rank merge loop, and ``tokenize``
producing fixed-length int32 rows of bare caption tokens (no SOT/EOT),
over the public CLIP merges ``assets/vocab/bpe_simple_vocab_16e6.txt.gz``.

The JAX package splits text with the third-party ``regex`` module and
CLIP's pattern ``<\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll
|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` under IGNORECASE. The port
compiles the same alternation for the standard ``re`` with each class
spelled out from ``unicodedata.category`` (:func:`split_pattern`), which
gives ``regex``'s split token for token:

- ``\\p{L}`` is the categories Lu, Ll, Lt, Lm and Lo, ``\\p{N}`` Nd, Nl
  and No (``re``'s ``[^\\W\\d_]`` would take ``²``, ``½`` and ``Ⅻ`` as
  letters); combining marks (Mn, Mc) are neither, so a decomposed ``é``
  splits before its accent.
- ``regex`` reads a newer Unicode than Python's ``unicodedata``: the
  letters and numbers assigned since 15.0 stand in :data:`NEWER_LETTERS`
  and :data:`NEWER_NUMBERS`, consulted only for code points that
  ``unicodedata`` calls unassigned.
- ``\\s`` is Unicode's White_Space (:data:`WHITE_SPACE`); ``re``'s ``\\s``
  (``str.isspace``) also takes U+001C-U+001F, which ``regex`` leaves to
  the "other" run.
- Under IGNORECASE, U+0345 (combining ypogegrammeni, which case-folds to
  a letter) matches no alternative and is dropped; ``s`` in the special
  tokens and contractions also matches U+017F (long s).

``fix_mojibake`` stands in for ``ftfy.fix_text`` where ftfy is not
installed, as in the JAX package.
"""
from __future__ import annotations

import gzip
import html
import os
import re
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import List, Optional, Union

import numpy as np


def fix_mojibake(text: str) -> str:
    """Repair UTF-8 text that was mis-decoded as cp1252/latin-1 (``Ã©`` ->
    ``é``): re-encode with the wrong codec and decode the bytes as UTF-8,
    up to three times for doubly encoded text. ASCII and correctly
    accented text come back unchanged."""
    for _ in range(3):
        fixed = None
        for enc in ("cp1252", "latin-1"):
            try:
                candidate = text.encode(enc).decode("utf-8")
            except (UnicodeEncodeError, UnicodeDecodeError):
                continue
            if candidate != text:
                fixed = candidate
                break
        if fixed is None:
            return text
        text = fixed
    return text


try:  # ftfy where it is installed, as the JAX package chooses
    from ftfy import fix_text as _fix_text
except ImportError:
    _fix_text = fix_mojibake

DEFAULT_BPE_PATHS = (
    "assets/vocab/bpe_simple_vocab_16e6.txt",
    "assets/vocab/bpe_simple_vocab_16e6.txt.gz",
)

# Unicode's White_Space property, a character-class body: ``regex``'s \s
WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029"
               "\u202f\u205f\u3000")

# letters (\p{L}) and numbers (\p{N}) assigned in Unicode 15.1-17.0, which
# Python 3.12's unicodedata (15.0) calls unassigned: inclusive ranges
NEWER_LETTERS = (
    (0x088F, 0x088F), (0x0C5C, 0x0C5C), (0x0CDC, 0x0CDC), (0x1C89, 0x1C8A),
    (0xA7CB, 0xA7CF), (0xA7D2, 0xA7D2), (0xA7D4, 0xA7D4), (0xA7DA, 0xA7DC),
    (0xA7F1, 0xA7F1), (0x105C0, 0x105F3), (0x10940, 0x10959),
    (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC7),
    (0x11380, 0x11389), (0x1138B, 0x1138B), (0x1138E, 0x1138E),
    (0x11390, 0x113B5), (0x113B7, 0x113B7), (0x113D1, 0x113D1),
    (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x11DB0, 0x11DDB),
    (0x13460, 0x143FA), (0x16100, 0x1611D), (0x16D40, 0x16D6C),
    (0x16EA0, 0x16EB8), (0x16EBB, 0x16ED3), (0x16FF2, 0x16FF3),
    (0x187F8, 0x187FF), (0x18CFF, 0x18CFF), (0x18D09, 0x18D1E),
    (0x18D80, 0x18DF2), (0x1E5D0, 0x1E5ED), (0x1E5F0, 0x1E5F0),
    (0x1E6C0, 0x1E6DE), (0x1E6E0, 0x1E6E2), (0x1E6E4, 0x1E6E5),
    (0x1E6E7, 0x1E6ED), (0x1E6F0, 0x1E6F4), (0x1E6FE, 0x1E6FF),
    (0x2B73A, 0x2B73F), (0x2CEA2, 0x2CEAD), (0x2EBF0, 0x2EE5D),
    (0x323B0, 0x33479),
)
NEWER_NUMBERS = (
    (0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9),
    (0x11DE0, 0x11DE9), (0x16130, 0x16139), (0x16D70, 0x16D79),
    (0x16FF4, 0x16FF6), (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA),
)
# matches no alternative of the split under IGNORECASE
DROPPED = "\u0345"


def _char_class(ranges) -> str:
    return "".join(re.escape(chr(a)) if a == b else
                   f"{re.escape(chr(a))}-{re.escape(chr(b))}"
                   for a, b in ranges)


def _merge(ranges) -> list:
    out: list = []
    for a, b in sorted(ranges):
        if out and a <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@lru_cache()
def unicode_classes() -> tuple:
    """(letters, numbers): ``regex``'s \\p{L} and \\p{N} as inclusive code
    point ranges, from one pass over ``unicodedata.category``."""
    letters: list = []
    numbers: list = []
    for cp in range(0x110000):
        major = unicodedata.category(chr(cp))[0]
        if major in "LN":
            runs = letters if major == "L" else numbers
            if runs and runs[-1][1] == cp - 1:
                runs[-1][1] = cp
            else:
                runs.append([cp, cp])

    def newer(table):
        return [[a, b] for a, b in table
                if unicodedata.category(chr(a)) == "Cn"]

    return (_merge(letters + newer(NEWER_LETTERS)),
            _merge(numbers + newer(NEWER_NUMBERS)))


def _ignorecase(word: str) -> str:
    """``word`` as ``regex`` matches it under IGNORECASE."""
    out = []
    for c in word:
        variants = c + c.upper() + ("\u017f" if c == "s" else "")
        out.append(re.escape(c) if len(set(variants)) == 1
                   else f"[{re.escape(variants)}]")
    return "".join(out)


@lru_cache()
def split_pattern() -> "re.Pattern":
    """CLIP's pre-token split, compiled for the standard ``re``."""
    letters, numbers = (_char_class(r) for r in unicode_classes())
    words = ["<|startoftext|>", "<|endoftext|>", "'s", "'t", "'re", "'ve",
             "'m", "'ll", "'d"]
    return re.compile("|".join(
        [_ignorecase(w) for w in words]
        + [f"[{letters}]+", f"[{numbers}]",
           f"[^{WHITE_SPACE}{letters}{numbers}{DROPPED}]+"]))


@lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode map (standard GPT-2/CLIP table)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


_WHITE_RUN = re.compile(f"[{WHITE_SPACE}]+")


def whitespace_clean(text: str) -> str:
    return _WHITE_RUN.sub(" ", text).strip()


def _find_bpe_file(path: Optional[str]) -> str:
    repo_root = Path(__file__).resolve().parents[2]
    candidates = [path] if path else []
    candidates += [str(Path(os.getcwd()) / p) for p in DEFAULT_BPE_PATHS]
    candidates += [str(repo_root / p) for p in DEFAULT_BPE_PATHS]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise FileNotFoundError(
        "CLIP BPE vocab not found. Pass bpe_path= or place "
        "bpe_simple_vocab_16e6.txt under assets/vocab/.")


class SimpleTokenizer:
    def __init__(self, bpe_path: Optional[str] = None,
                 text_length: int = 256,
                 truncate_captions: bool = True) -> None:
        self.context_length = text_length
        self.truncate_text = truncate_captions
        bpe_path = _find_bpe_file(bpe_path)
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]

        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.pat = split_pattern()
        self.vocab_size = len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t]
                              for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens) -> str:
        tokens = [int(t) for t in np.asarray(tokens).reshape(-1)]
        text = "".join(self.decoder.get(t, "") for t in tokens)
        text = bytearray(self.byte_decoder.get(c, 32) for c in text).decode(
            "utf-8", errors="replace").replace("</w>", " ")
        for special in ("<|startoftext|>", "<|endoftext|>"):
            text = text.replace(special, "")
        return text.strip()

    def tokenize(self, texts: Union[str, List[str]],
                 context_length: Optional[int] = None,
                 truncate_text: Optional[bool] = None) -> np.ndarray:
        """Fixed-length int32 token matrix: bare caption tokens, no SOT/EOT
        wrapping, zero-padded."""
        single = isinstance(texts, str)
        if single:
            texts = [texts]
        context_length = (self.context_length if context_length is None
                          else context_length)
        truncate_text = (self.truncate_text if truncate_text is None
                         else truncate_text)
        result = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            tokens = self.encode(text)
            if len(tokens) > context_length:
                if truncate_text:
                    tokens = tokens[:context_length]
                else:
                    raise RuntimeError(
                        f"Input {text!r} is too long for context length "
                        f"{context_length}")
            result[i, :len(tokens)] = tokens
        return result[0] if single else result
