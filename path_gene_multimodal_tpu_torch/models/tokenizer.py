"""CLIP BPE tokenizer (pure Python, zero deps): a copy of the JAX
package's ``models/tokenizer.py``.

The reference gets tokenization for free inside Mussel's CLIP stack; here we
own it. Implements OpenAI CLIP's byte-pair-encoding exactly (lower-case,
whitespace-collapse, html-unescape-free simple cleaning, byte-level BPE with
``</w>`` word terminators, SOT=49406 / EOT=49407, context 77), loading
merges from either:

- the OpenAI ``bpe_simple_vocab_16e6.txt.gz`` file, or
- HuggingFace ``vocab.json`` + ``merges.txt``.

No vocab files ship with this repo, so
``FallbackTokenizer`` provides a deterministic hash-based scheme for tests
and synthetic runs — it is NOT CLIP-compatible and says so loudly; real
zero-shot annotation requires the real vocab + converted CLIP weights.
"""

from __future__ import annotations

import gzip
import json
import re
from functools import lru_cache
from pathlib import Path

import numpy as np

SOT_TOKEN = 49406
EOT_TOKEN = 49407
CONTEXT_LENGTH = 77

# stdlib `re` lacks \p{L}/\p{N}; ASCII classes cover CLIP's English prompts
_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE,
)


@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte→unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class CLIPTokenizer:
    """Exact CLIP BPE given real vocab files."""

    def __init__(
        self,
        bpe_path: str | Path | None = None,
        vocab_json: str | Path | None = None,
        merges_txt: str | Path | None = None,
    ):
        self.byte_encoder = bytes_to_unicode()
        if bpe_path is not None:
            merges = self._read_openai_merges(Path(bpe_path))
            vocab = [v for v in self.byte_encoder.values()]
            vocab += [v + "</w>" for v in vocab]
            vocab += ["".join(m) for m in merges]
            vocab += ["<|startoftext|>", "<|endoftext|>"]
            self.encoder = {t: i for i, t in enumerate(vocab)}
        elif vocab_json is not None and merges_txt is not None:
            self.encoder = json.loads(Path(vocab_json).read_text())
            lines = Path(merges_txt).read_text().splitlines()
            if lines and lines[0].startswith("#"):
                lines = lines[1:]
            merges = [tuple(l.split()) for l in lines if l.strip()]
        else:
            raise ValueError("provide bpe_path or vocab_json+merges_txt")
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        # pre-seed the special tokens (OpenAI's tokenizer does the same):
        # without it _bpe() would decompose a literal "<|endoftext|>" in the
        # prompt into byte pieces instead of the single special id
        self._cache: dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    @staticmethod
    def _read_openai_merges(path: Path) -> list[tuple[str, str]]:
        opener = gzip.open if path.suffix == ".gz" else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # OpenAI file: first line is a version header; merges at 1:49152-256-2+1
        merges = lines[1 : 49152 - 256 - 2 + 1]
        return [tuple(m.split()) for m in merges if m]

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for tok in _PAT.findall(_clean(text)):
            tok_b = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok_b).split(" "))
        return ids

    def __call__(self, texts: list[str], context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [SOT_TOKEN] + self.encode(text) + [EOT_TOKEN]
            if len(ids) > context_length:  # truncate, keep EOT (CLIP behavior)
                ids = ids[: context_length - 1] + [EOT_TOKEN]
            out[i, : len(ids)] = ids
        return out


class FallbackTokenizer:
    """Deterministic hash tokenizer for environments without the CLIP vocab.

    NOT CLIP-compatible: embeddings produced through it are only meaningful
    relative to other embeddings from the same (weights, tokenizer) pair —
    fine for tests, synthetic pipelines and plumbing benchmarks; wrong for
    real zero-shot annotation. ``is_clip_compatible`` lets callers warn.
    """

    is_clip_compatible = False

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> list[int]:
        ids = []
        for tok in _PAT.findall(_clean(text)):
            h = 0
            for ch in tok.encode("utf-8"):
                h = (h * 131 + ch) % (self.vocab_size - 1000)
            ids.append(1000 + h % (self.vocab_size - 2000))
        return ids

    def __call__(self, texts: list[str], context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [SOT_TOKEN] + self.encode(text)[: context_length - 2] + [EOT_TOKEN]
            out[i, : len(ids)] = ids
        return out


def find_vocab_files() -> dict[str, Path] | None:
    """Discover CLIP vocab files without network access. Search order:

    1. ``$PGM_CLIP_BPE`` — path to OpenAI ``bpe_simple_vocab_16e6.txt.gz``;
    2. ``$PGM_CLIP_VOCAB_DIR`` — directory with HF ``vocab.json`` +
       ``merges.txt``;
    3. ``<package>/assets/`` — drop either format there to vendor it;
    4. the HuggingFace hub cache (``~/.cache/huggingface/hub``) for any
       ``models--*clip*`` snapshot (populated by e.g.
       ``hf download openai/clip-vit-base-patch16 vocab.json merges.txt``
       on a connected machine).
    """
    import os

    env_bpe = os.environ.get("PGM_CLIP_BPE")
    if env_bpe and Path(env_bpe).is_file():
        return {"bpe_path": Path(env_bpe)}
    env_dir = os.environ.get("PGM_CLIP_VOCAB_DIR")
    candidates = []
    if env_dir:
        candidates.append(Path(env_dir))
    assets = Path(__file__).resolve().parent.parent / "assets"
    candidates.append(assets)
    hub = Path(os.environ.get("HF_HOME", Path.home() / ".cache" / "huggingface")) / "hub"
    if hub.is_dir():
        for repo in sorted(hub.glob("models--*clip*")):
            candidates.extend(sorted(repo.glob("snapshots/*")))
    for d in candidates:
        if not d.is_dir():
            continue
        gz = d / "bpe_simple_vocab_16e6.txt.gz"
        if gz.is_file():
            return {"bpe_path": gz}
        vj, mt = d / "vocab.json", d / "merges.txt"
        if vj.is_file() and mt.is_file():
            return {"vocab_json": vj, "merges_txt": mt}
    return None


def open_tokenizer(
    bpe_path: str | Path | None = None,
    vocab_json: str | Path | None = None,
    merges_txt: str | Path | None = None,
):
    """Best tokenizer the environment allows: explicit paths, else
    auto-discovered vocab files (``find_vocab_files``), else the loud
    non-CLIP fallback."""
    if bool(vocab_json) != bool(merges_txt):
        # a half-specified explicit pair must not silently degrade to
        # discovery / the non-CLIP fallback
        raise ValueError("vocab_json and merges_txt must be given together")
    if bpe_path or (vocab_json and merges_txt):
        return CLIPTokenizer(bpe_path, vocab_json, merges_txt)
    found = find_vocab_files()
    if found:
        import os

        tok = CLIPTokenizer(**found)
        # explicit env-var paths are trusted (the user chose them); the
        # assets/hub-cache auto-glob can surface non-OpenAI *clip* repos
        # whose vocab doesn't match the CLIP text tower (49408 tokens) —
        # wrong ids would silently degrade zero-shot scores, so validate
        # those and fall back loudly instead
        env_dirs = {
            str(Path(v).resolve())
            for v in (
                os.environ.get("PGM_CLIP_BPE"),
                os.environ.get("PGM_CLIP_VOCAB_DIR"),
            )
            if v
        }
        trusted = any(
            str(Path(p).resolve()) in env_dirs
            or str(Path(p).resolve().parent) in env_dirs
            for p in found.values()
        )
        if trusted or len(tok.encoder) == 49408:
            return tok
        import warnings

        warnings.warn(
            f"discovered CLIP vocab {found} has {len(tok.encoder)} tokens "
            "(expected 49408 for the OpenAI CLIP text tower) — ignoring it",
            stacklevel=2,
        )
    return FallbackTokenizer()
