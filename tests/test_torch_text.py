"""Steps 3-4 of the port against the JAX package on the CPU: the tokenizer
(the fallback and the BPE over a vocab the test writes), the CLIP text
tower in f32 with the JAX weights carried across (atol 5e-4 / rtol 1e-3;
the context crop with EOT re-pinned, the pad, the vocab fold), the JAX
converter reading the port's state dict back with no key left over, and
the class embeddings + zero-shot annotation (CSV rows, artifacts)."""

import json

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from path_gene_multimodal_tpu.models import clip as jclip
from path_gene_multimodal_tpu.models import tokenizer as jtok
from path_gene_multimodal_tpu.models.weights import convert_clip_text
from path_gene_multimodal_tpu.pipeline import embed as jembed
from path_gene_multimodal_tpu_torch.config import DEFAULT_CLASSES
from path_gene_multimodal_tpu_torch.models import clip as tclip
from path_gene_multimodal_tpu_torch.models import tokenizer as ttok
from path_gene_multimodal_tpu_torch.models.weights_clip import text_state_dict_from_jax
from path_gene_multimodal_tpu_torch.pipeline import embed as tembed

ATOL, RTOL = 5e-4, 1e-3
PROMPTS = list(DEFAULT_CLASSES) + ["a", "tumor stroma, lymphocytes; necrosis!", "x " * 90]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _vocab_files(tmp_path):
    be = ttok.bytes_to_unicode()
    vocab = {}
    for t in be.values():
        vocab[t] = len(vocab)
    for t in be.values():
        vocab[t + "</w>"] = len(vocab)
    merges = [("t", "u"), ("tu", "m"), ("tum", "or</w>"), ("o", "r</w>"), ("s", "t"),
              ("st", "r"), ("e", "s</w>")]
    for m in merges:
        vocab.setdefault("".join(m), len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version\n" + "\n".join(" ".join(m) for m in merges))
    return tmp_path / "vocab.json", tmp_path / "merges.txt"


def test_tokenizers_match_jax(tmp_path, monkeypatch):
    np.testing.assert_array_equal(ttok.FallbackTokenizer()(PROMPTS),
                                  jtok.FallbackTokenizer()(PROMPTS))
    np.testing.assert_array_equal(ttok.FallbackTokenizer(5000)(PROMPTS, 16),
                                  jtok.FallbackTokenizer(5000)(PROMPTS, 16))
    vj, mt = _vocab_files(tmp_path)
    t, j = ttok.CLIPTokenizer(vocab_json=vj, merges_txt=mt), jtok.CLIPTokenizer(
        vocab_json=vj, merges_txt=mt)
    prompts = PROMPTS + ["<|endoftext|> tumor", "stress tests"]
    np.testing.assert_array_equal(t(prompts), j(prompts))
    assert t.encode("tumor") == j.encode("tumor") == [t.encoder["tumor</w>"]]
    for var in ("PGM_CLIP_BPE", "PGM_CLIP_VOCAB_DIR", "HF_HOME"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no_hub"))
    assert isinstance(ttok.open_tokenizer(), ttok.FallbackTokenizer)
    monkeypatch.setenv("PGM_CLIP_VOCAB_DIR", str(tmp_path))
    assert ttok.find_vocab_files() == {"vocab_json": vj, "merges_txt": mt}
    assert isinstance(ttok.open_tokenizer(), ttok.CLIPTokenizer)
    with pytest.raises(ValueError, match="together"):
        ttok.open_tokenizer(vocab_json=vj)


TEXT_CFGS = {
    "small": dict(vocab_size=49408, context_length=77, width=32, layers=2, heads=2, out_dim=24),
    "crop_fold": dict(vocab_size=1000, context_length=16, width=48, layers=1, heads=4,
                      out_dim=16, mlp_ratio=2.0),
}


def _towers(name, seed=3):
    jcfg = jclip.TextConfig(**TEXT_CFGS[name])
    tcfg = tclip.TextConfig(**TEXT_CFGS[name])
    jenc = jclip.TextEncoder(jcfg, seed=seed)
    params = jax.tree_util.tree_map(np.asarray, jenc.params)
    tenc = tclip.TextEncoder(tcfg, state_dict=text_state_dict_from_jax(params, tcfg),
                             device="cpu")
    return jenc, tenc, params, jcfg


@pytest.mark.parametrize("name", list(TEXT_CFGS))
def test_text_tower_matches_jax(name):
    jenc, tenc, _, _ = _towers(name)
    ids = jtok.FallbackTokenizer()(PROMPTS)  # 77 wide: "crop_fold" crops + folds
    want = np.asarray(jenc(jnp.asarray(ids)))
    got = tenc(ids)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    short = ids[:, :10].copy()  # padded up to the context
    np.testing.assert_allclose(tenc(short).numpy(), np.asarray(jenc(jnp.asarray(short))),
                               atol=ATOL, rtol=RTOL)


def test_eot_position_matters():
    """Features are read at the first EOT: a later second EOT changes
    nothing, and ids without their EOT (pooled at the first highest id
    instead) fail the comparison the test above makes."""
    jenc, tenc, _, _ = _towers("small")
    ids = jtok.FallbackTokenizer()(PROMPTS[:3])
    want = np.asarray(jenc(jnp.asarray(ids)))
    moved = ids.copy()
    moved[:, -1] = 49407  # a second EOT later: argmax keeps the first
    np.testing.assert_allclose(tenc(moved).numpy(), np.asarray(jenc(jnp.asarray(moved))),
                               atol=ATOL, rtol=RTOL)
    assert not np.allclose(tenc(np.where(ids == 49407, 0, ids)).numpy(), want,
                           atol=ATOL, rtol=RTOL)


class _Tracking(dict):
    def __init__(self, d):
        super().__init__(d)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def test_jax_converter_reads_port_state_dict():
    _, tenc, params, jcfg = _towers("small")
    sd = _Tracking({k: v.numpy() for k, v in tenc.model.state_dict().items()})
    back = convert_clip_text(sd, jcfg)
    assert set(sd) - sd.read == set()
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_b[path]))


def test_class_embeddings_and_annotation_match_jax(tmp_path):
    jenc, tenc, _, _ = _towers("small")
    classes = list(DEFAULT_CLASSES)
    tok = ttok.FallbackTokenizer()
    want = jembed.run_create_class_embeddings(classes, jenc, jtok.FallbackTokenizer(),
                                              tmp_path / "j", "s")
    got = tembed.run_create_class_embeddings(classes, tenc, tok, tmp_path / "t", "s")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "s_classes.npy"), got)
    np.testing.assert_array_equal(torch.load(tmp_path / "t" / "s_classes.pt").numpy(), got)

    feats = np.random.default_rng(5).standard_normal((300, 24)).astype(np.float32)
    jdf = jembed.run_annotation(feats, want, classes, tmp_path / "j", "s")
    tdf = tembed.run_annotation(feats, want, classes, tmp_path / "t", "s", device="cpu")
    a = pd.read_csv(tmp_path / "t" / "s_annotations.csv")
    b = pd.read_csv(tmp_path / "j" / "s_annotations.csv")
    assert list(a.columns) == list(b.columns) == list(tdf.columns) == list(jdf.columns)
    np.testing.assert_array_equal(a["tile_index"], b["tile_index"])
    assert (a["predicted_class"] == b["predicted_class"]).all()
    np.testing.assert_allclose(a[classes].to_numpy(), b[classes].to_numpy(), atol=ATOL,
                               rtol=RTOL)
    with pytest.raises(ValueError, match="no tile features"):
        tembed.run_annotation(np.zeros((0, 24), np.float32), want, classes, tmp_path, "e",
                              device="cpu")
