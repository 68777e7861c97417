"""The port's CLIP tokenizer against the JAX package's, on the same
vocabulary and merges: the prompts of examples/*prompts*.yaml, unicode, text
past 77 tokens; `from_pretrained` over vocab.json + merges.txt and the gzip
distribution; the synthetic tokenizer `leco_tpu_torch.testing` writes."""

import gzip
import json
from pathlib import Path

import numpy as np
import pytest
import yaml

from leco_tpu.models.tokenizer import CLIPTokenizer as JaxTokenizer
from leco_tpu.models.tokenizer import _bytes_to_unicode, make_tiny_tokenizer
from leco_tpu_torch.models.tokenizer import CLIPTokenizer, split_words
from leco_tpu_torch.testing import write_tokenizer

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example_prompts() -> list[str]:
    out = []
    for path in sorted(EXAMPLES.glob("*prompts*.yaml")):
        for entry in yaml.safe_load(path.read_text()):
            out += [entry.get(k) for k in ("target", "positive", "unconditional", "neutral")]
    return sorted({p for p in out if p is not None})


PROMPTS = _example_prompts()
EXTRA = [
    "Café crème, naïve — 東京 ½ ² ①",
    "don't stop: it's van gogh's 1girl!!! <|endoftext|> x",
    "  spaced\tout\n text  ",
    "&amp; html &lt;escapes&gt;",
    "word " * 100,  # past 75 tokens: truncated
]
WORDS = sorted({w for p in PROMPTS for w in p.replace(",", " ").split()})


@pytest.fixture(scope="module")
def pair():
    jax_tok = make_tiny_tokenizer(WORDS)
    merges = sorted(jax_tok.bpe_ranks, key=jax_tok.bpe_ranks.get)
    # a byte-level base, as CLIP's vocabulary has, so any text tokenizes
    for c in _bytes_to_unicode().values():
        for piece in (c, c + "</w>"):
            jax_tok.vocab.setdefault(piece, len(jax_tok.vocab))
    jax_tok = JaxTokenizer(jax_tok.vocab, merges)
    return jax_tok, CLIPTokenizer(jax_tok.vocab, merges)


@pytest.mark.parametrize("text", PROMPTS + EXTRA)
def test_ids_match_jax(pair, text):
    jax_tok, tok = pair
    assert tok.tokenize(text) == jax_tok.tokenize(text)
    got, want = tok([text, "van gogh"]), jax_tok([text, "van gogh"])
    assert got.dtype == np.int32 and got.shape == (2, 77)
    np.testing.assert_array_equal(got, want)


def test_truncation_and_padding(pair):
    _, tok = pair
    ids = tok("word " * 100)[0]
    assert ids[0] == tok.bos_token_id and ids[76] == tok.eos_token_id
    short = tok("van gogh")[0]
    n = 2 + len(tok.tokenize("van gogh"))
    assert short[n - 1] == tok.eos_token_id and (short[n:] == tok.pad_token_id).all()
    assert CLIPTokenizer(tok.vocab, [], pad_token_id=0)("van")[0, -1] == 0


@pytest.mark.parametrize("text", ["van gogh's", "abc123def", "x½y", "a-b_c", "<|startoftext|>hi"])
def test_split_words_matches_the_regex_pattern(text):
    import regex

    pattern = regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        regex.IGNORECASE,
    )
    assert split_words(text) == pattern.findall(text)


@pytest.mark.parametrize("gz", [False, True])
def test_from_pretrained_matches_jax(pair, tmp_path, gz):
    jax_tok, _ = pair
    d = tmp_path / "tokenizer"
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps(jax_tok.vocab))
    merges = sorted(jax_tok.bpe_ranks, key=jax_tok.bpe_ranks.get)
    text = "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges)
    if gz:
        with gzip.open(d / "bpe_simple_vocab_16e6.txt.gz", "wt", encoding="utf-8") as f:
            f.write(text)
    else:
        (d / "merges.txt").write_text(text)
    tok = CLIPTokenizer.from_pretrained(str(tmp_path))  # the parent works too
    want = JaxTokenizer.from_pretrained(str(d))
    np.testing.assert_array_equal(tok(PROMPTS + EXTRA), want(PROMPTS + EXTRA))


def test_synthetic_tokenizer(tmp_path):
    """Byte-level base, one token per listed word, CLIP's special ids."""
    write_tokenizer(tmp_path, ["van", "gogh"])
    tok = CLIPTokenizer.from_pretrained(str(tmp_path))
    assert (tok.bos_token_id, tok.eos_token_id, tok.pad_token_id) == (49406, 49407, 49407)
    assert len(tok.tokenize("van gogh")) == 2
    ids = tok(PROMPTS + EXTRA)
    assert ids.max() < 49408 and ids.min() >= 0
    np.testing.assert_array_equal(ids, JaxTokenizer.from_pretrained(str(tmp_path))(PROMPTS + EXTRA))
