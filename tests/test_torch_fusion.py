"""The port's fusion slice against the JAX package on the CPU:
``slide_embedding`` and ``GeneExpressionTable`` (exact), ``AttentionPool``
with and without a mask and on an all-padding bag, ``FusionHead``'s forward
from carried weights (atol 5e-4, rtol 1e-3), five trainer steps at dropout
0 (losses rtol 1e-4; parameters atol 5e-4, rtol 1e-3, but for entries
whose Adam step went the other way: see ``_assert_params_close``), the
checkpoint resume at dropout 0.1 (bit for bit), and the linear-probe step
in both modes on the small tower of ``tests/test_parallel.py`` (image 32,
patch 16, width 32, one layer). JAX variables are drawn with numpy over
``jax.eval_shape`` of the init."""

import numpy as np
import optax
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from path_gene_multimodal_tpu.models import clip as jclip
from path_gene_multimodal_tpu.models import fusion as jfus
from path_gene_multimodal_tpu.parallel.train import make_linear_probe_step as j_probe
from path_gene_multimodal_tpu_torch.core.checkpoints import flatten_params, load_params, save_params
from path_gene_multimodal_tpu_torch.models import clip as tclip
from path_gene_multimodal_tpu_torch.models import fusion as tfus
from path_gene_multimodal_tpu_torch.models.weights_clip import vision_state_dict_from_jax
from path_gene_multimodal_tpu_torch.models.weights_fusion import (
    fusion_state_dict_from_jax,
    pool_state_dict_from_jax,
)
from path_gene_multimodal_tpu_torch.parallel.train import make_linear_probe_step as t_probe

ATOL, RTOL, LOSS_RTOL = 5e-4, 1e-3, 1e-4


@pytest.fixture(autouse=True)
def _threads():
    # small torch ops on many threads crawl when six test workers share the
    # cores: cap them, as the other files that run torch on the CPU do
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _draw(shapes, seed: int, bias_std: float = 0.05):
    """numpy values in a flax tree of shapes: kernels N(0, 1/fan_in), every
    vector N(0, bias_std²)."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        if leaf.ndim == 1:
            return rng.normal(0, bias_std, leaf.shape).astype(np.float32)
        return rng.normal(0, np.prod(leaf.shape[:-1]) ** -0.5, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _assert_params_close(got: dict, want: dict, grads: dict, lr: float, steps: int):
    """Parameters within atol 5e-4 / rtol 1e-3, except entries whose JAX
    gradient sits near zero (|g| <= 1e-3 of the tensor's largest): there
    the two f32 gradients, equal to their last bits elsewhere, can take
    opposite signs, and Adam's normalised step of about ``lr`` goes the
    other way. Those entries (named, at most 1%) may differ by up to 2 lr a
    step."""
    for k, w in want.items():
        g, w = got[k], np.asarray(w)
        off = ~np.isclose(g, w, atol=ATOL, rtol=RTOL)
        if not off.any():
            continue
        gk = np.abs(grads[k])
        near_zero = gk <= 1e-3 * gk.max()
        assert (near_zero | ~off).all(), f"{k}: {int((off & ~near_zero).sum())} entries off the bar"
        assert off.mean() <= 0.01, f"{k}: {int(off.sum())} flipped entries"
        assert np.abs(g - w)[off].max() <= 2 * lr * steps + ATOL, k


def test_slide_embedding_exact():
    f = np.random.default_rng(0).normal(size=(37, 12)).astype(np.float32)
    for method in ("mean", "max", "mean_max"):
        got, want = tfus.slide_embedding(f, method), jfus.slide_embedding(f, method)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tfus.slide_embedding(np.zeros((0, 4)), "mean")
    with pytest.raises(ValueError):
        tfus.slide_embedding(f, "median")


@pytest.mark.parametrize("suffix,kw", [(".csv", {}), (".tsv", {}), (".csv", {"log1p": False}),
                                       (".csv", {"zscore": False})])
def test_gene_expression_table_exact(tmp_path, suffix, kw):
    rng = np.random.default_rng(1)
    raw = np.exp(rng.normal(size=(30, 9))).astype(np.float32)
    raw[3, 2] = -1.0  # clipped by log1p's max(·, 0)
    raw[5] = 2.0  # a constant gene: sd 0 → divided by 1e-8
    path = tmp_path / f"expr{suffix}"
    pd.DataFrame(raw, index=[f"G{i}" for i in range(30)],
                 columns=[f"TCGA-{i:02d}.x" for i in range(9)]).to_csv(
        path, sep="\t" if suffix == ".tsv" else ",")
    got, want = tfus.GeneExpressionTable.from_csv(path, **kw), jfus.GeneExpressionTable.from_csv(
        path, **kw)
    assert got.samples == want.samples and got.genes == want.genes
    assert got.values.dtype == want.values.dtype
    assert got.values.tobytes() == want.values.tobytes()
    np.testing.assert_array_equal(got.vector_for("TCGA-04.x"), want.vector_for("TCGA-04.x"))
    with pytest.raises(KeyError):
        got.vector_for("nope")


def _pool(dim=24, hidden=16, seed=2):
    shapes = jax.eval_shape(jfus.AttentionPool(hidden=hidden).init, jax.random.PRNGKey(0),
                            jnp.zeros((4, dim)))
    jp = _draw(shapes, seed)
    pool = tfus.AttentionPool(dim, hidden)
    pool.load_state_dict(pool_state_dict_from_jax(jp))
    return jfus.AttentionPool(hidden=hidden), jp, pool


def test_attention_pool_matches_jax():
    jpool, jp, pool = _pool()
    rng = np.random.default_rng(3)
    bags = rng.normal(size=(3, 40, 24)).astype(np.float32)
    mask = rng.random((3, 40)) < 0.6
    mask[2] = False  # an all-padding bag
    with torch.no_grad():
        got_plain = pool(torch.from_numpy(bags)).numpy()
        got_mask = pool(torch.from_numpy(bags), torch.from_numpy(mask)).numpy()
    for b in range(3):
        np.testing.assert_allclose(got_plain[b], np.asarray(jpool.apply(jp, bags[b])),
                                   atol=ATOL, rtol=RTOL)
        want = np.asarray(jpool.apply(jp, bags[b], jnp.asarray(mask[b])))
        np.testing.assert_allclose(got_mask[b], want, atol=ATOL, rtol=RTOL)
    assert np.all(got_mask[2] == 0) and np.all(np.asarray(jpool.apply(jp, bags[2], mask[2])) == 0)
    # one bag alone, unbatched, as the JAX module takes it
    with torch.no_grad():
        one = pool(torch.from_numpy(bags[0]), torch.from_numpy(mask[0])).numpy()
    np.testing.assert_array_equal(one, got_mask[0])


def test_attention_pool_all_padding_gradient_is_finite():
    """JAX's softmax over an all -inf row is NaN under the select; the
    port's zeroed scores keep the gradient finite (and the output 0)."""
    _, _, pool = _pool()
    x = torch.randn(2, 10, 24, generator=torch.Generator().manual_seed(0), requires_grad=True)
    mask = torch.zeros(2, 10, dtype=torch.bool)
    mask[0, :4] = True
    pool(x, mask).sum().backward()
    assert torch.isfinite(x.grad).all()
    assert all(torch.isfinite(p.grad).all() for p in pool.parameters())


def _head(hist_dim, gene_dim, seed, **kw):
    jmodel = jfus.FusionHead(**kw)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, hist_dim)),
                            jnp.zeros((1, gene_dim)))
    jp = _draw(shapes, seed)
    return jmodel, jp, tfus.FusionHead(hist_dim, gene_dim, **kw)


def _cohort(n, hist_dim, gene_dim, seed):
    rng = np.random.default_rng(seed)
    hist = rng.normal(size=(n, hist_dim)).astype(np.float32)
    genes = rng.normal(size=(n, gene_dim)).astype(np.float32)
    return hist, genes, ((hist[:, 0] + genes[:, 0]) > 0).astype(np.int32)


def test_fusion_head_forward_matches_jax():
    jmodel, jp, model = _head(20, 11, 4, num_outputs=3, proj_dim=16, hidden=12)
    model.load_state_dict(fusion_state_dict_from_jax(jp))
    hist, genes, _ = _cohort(17, 20, 11, 5)
    with torch.no_grad():
        got = model(torch.from_numpy(hist), torch.from_numpy(genes)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(jp, hist, genes)), atol=ATOL, rtol=RTOL)
    # train mode without dropout is the eval forward
    with torch.no_grad():
        model.dropout = 0.0
        np.testing.assert_array_equal(
            model(torch.from_numpy(hist), torch.from_numpy(genes), train=True).numpy(), got)


def test_fusion_trainer_five_steps_match_jax():
    lr, steps = 1e-2, 5
    kw = dict(num_outputs=2, proj_dim=16, hidden=16, dropout=0.0)
    jmodel, jp, model = _head(32, 20, 6, **kw)
    hist, genes, labels = _cohort(64, 32, 20, 7)
    jstate, jstep, jpredict = jfus.make_fusion_trainer(jmodel, 32, 20, lr)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    jstate = {"params": jp, "opt": optax.adamw(lr).init(jp), "rng": jstate["rng"]}
    state, step, predict = tfus.make_fusion_trainer(model, 32, 20, lr, device="cpu")
    carried = fusion_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    assert {k: v.shape for k, v in carried.items()} == {
        k: v.shape for k, v in state["params"].items()}
    state = dict(state, params=carried)  # JAX's weights in place of the seeded draw
    jlosses, losses, grads = [], [], {}
    jgrad = jax.jit(jax.grad(lambda p: optax.softmax_cross_entropy_with_integer_labels(
        jmodel.apply(p, hist, genes), labels).mean()))
    for _ in range(steps):
        g = jgrad(jstate["params"])
        for k, v in fusion_state_dict_from_jax(g).items():
            grads[k] = np.minimum(grads.get(k, np.inf), np.abs(v.numpy()))
        jstate, jloss = jstep(jstate, hist, genes, labels)
        state, loss = step(state, hist, genes, labels)
        jlosses.append(float(jloss))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    want = {k: v.numpy() for k, v in fusion_state_dict_from_jax(jstate["params"]).items()}
    _assert_params_close({k: v.numpy() for k, v in state["params"].items()}, want, grads, lr,
                         steps)
    np.testing.assert_allclose(predict(state, hist, genes).numpy(),
                               np.asarray(jpredict(jstate, hist, genes)), atol=ATOL, rtol=RTOL)
    assert int(state["opt"]["count"]) == int(jstate["opt"][0].count) == steps


def test_fusion_trainer_checkpoint_resume_bit_exact(tmp_path):
    """Save the whole training state (parameters, Adam moments and count,
    the dropout generator) mid-run at dropout 0.1, restore it and go on:
    the restore equals the saved state and the resumed steps equal the
    uninterrupted run, bit for bit; a second trainer's state of the same
    seed is the ``like`` tree."""
    hist, genes, labels = _cohort(32, 16, 8, 8)
    model = tfus.FusionHead(16, 8, num_outputs=2, proj_dim=8, hidden=8, dropout=0.1)
    state, step, _ = tfus.make_fusion_trainer(model, 16, 8, 1e-2, seed=3, device="cpu")
    mid = mid_state = None
    for i in range(6):
        if i == 3:
            mid, mid_state = save_params(state, tmp_path / "train.state"), state
        state, _ = step(state, hist, genes, labels)
    assert mid.name == "train.state.pt"
    restored = load_params(tmp_path / "train.state",
                           like=tfus.make_fusion_trainer(model, 16, 8, 1e-2, seed=3,
                                                         device="cpu")[0])
    flat_r, flat_m = flatten_params(restored), flatten_params(mid_state)
    assert sorted(flat_r) == sorted(flat_m)
    assert all(torch.equal(flat_r[k], flat_m[k]) for k in flat_m)
    for _ in range(3):
        restored, _ = step(restored, hist, genes, labels)
    flat_r, flat_s = flatten_params(restored), flatten_params(state)
    assert all(torch.equal(flat_r[k], flat_s[k]) for k in flat_s)
    # dropout really drew: a run with another generator state differs
    other = dict(mid_state, rng=torch.Generator().manual_seed(99).get_state())
    for _ in range(3):
        other, _ = step(other, hist, genes, labels)
    assert not torch.equal(other["params"]["fc2.weight"], state["params"]["fc2.weight"])


def test_load_params_refuses_another_tree(tmp_path):
    model = tfus.FusionHead(6, 4, proj_dim=4, hidden=4)
    state = tfus.make_fusion_trainer(model, 6, 4, device="cpu")[0]
    path = save_params(state, tmp_path / "s")
    other = tfus.make_fusion_trainer(tfus.FusionHead(6, 5, proj_dim=4, hidden=4), 6, 5,
                                     device="cpu")[0]
    with pytest.raises(ValueError, match="expected"):
        load_params(path, like=other)
    with pytest.raises(ValueError, match="missing"):
        load_params(path, like={"params": state["params"]})
    with pytest.raises(ValueError):
        tfus.make_fusion_trainer(model, 7, 4, device="cpu")


VCFG = dict(image_size=32, patch_size=16, width=32, layers=1, heads=2, out_dim=16)


@pytest.mark.parametrize("train_encoder", [False, True])
def test_linear_probe_step_matches_jax(train_encoder):
    lr, steps = 1e-3, 3
    jcfg, tcfg = jclip.VisionConfig(**VCFG), tclip.VisionConfig(**VCFG)
    jtower = jclip.VisionTower(jcfg, dtype=jnp.float32)
    shapes = jax.eval_shape(jtower.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(9)
    jparams = jax.tree_util.tree_map(
        lambda leaf: (1.0 * (leaf.ndim == 1) + rng.normal(0, 0.05, leaf.shape)).astype(np.float32)
        if leaf.ndim == 1 else rng.normal(0, np.prod(leaf.shape[:-1]) ** -0.5,
                                          leaf.shape).astype(np.float32), shapes)
    tiles = rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    pixels = np.array(jclip.preprocess_tiles(jnp.asarray(tiles)))
    labels = rng.integers(0, 5, 16).astype(np.int32)
    w = (rng.normal(size=(16, 5)) * 0.02).astype(np.float32)

    j_init, j_step = j_probe(lambda p, px: jtower.apply(p, px), jparams, feature_dim=16,
                             num_classes=5, learning_rate=lr, train_encoder=train_encoder)
    jstate = j_init(jax.random.PRNGKey(1))
    jstate["params"]["head"]["w"] = jnp.asarray(w)
    tower = tclip.VisionTower(tcfg, dtype=torch.float32)
    tower.load_state_dict(vision_state_dict_from_jax(jparams, tcfg))
    t_init, t_step = t_probe(tower, 16, 5, learning_rate=lr, train_encoder=train_encoder,
                             device="cpu")
    state = t_init(torch.Generator().manual_seed(1))
    assert set(state["params"]) == {"head.b", "head.w"} | (
        {f"encoder.{k}" for k in tower.state_dict()} if train_encoder else set())
    state["params"]["head.w"] = torch.from_numpy(w)
    grads = {}
    jlosses, losses = [], []
    jgrad = jax.jit(jax.grad(lambda p: optax.softmax_cross_entropy_with_integer_labels(
        jtower.apply(p.get("encoder", jparams), pixels) @ p["head"]["w"] + p["head"]["b"],
        labels).mean()))
    for _ in range(steps):
        jg = jgrad(jstate["params"])
        for k, v in _probe_names(jg, tcfg).items():
            grads[k] = np.minimum(grads.get(k, np.inf), np.abs(v))
        jstate, jloss = j_step(jstate, pixels, labels)
        state, loss = t_step(state, torch.from_numpy(pixels), torch.from_numpy(labels))
        jlosses.append(float(jloss))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    want = _probe_names(jstate["params"], tcfg)
    _assert_params_close({k: v.numpy() for k, v in state["params"].items()}, want, grads, lr,
                         steps)
    if not train_encoder:  # the frozen tower's weights never move
        sd = vision_state_dict_from_jax(jparams, tcfg)
        assert all(torch.equal(v, sd[k]) for k, v in tower.state_dict().items())


def _probe_names(tree, tcfg) -> dict[str, np.ndarray]:
    """A JAX probe parameter tree under the port's state names."""
    out = {"head.w": np.asarray(tree["head"]["w"]), "head.b": np.asarray(tree["head"]["b"])}
    if "encoder" in tree:
        np_tree = jax.tree_util.tree_map(np.asarray, tree["encoder"])
        out.update({f"encoder.{k}": v.numpy()
                    for k, v in vision_state_dict_from_jax(np_tree, tcfg).items()})
    return out
