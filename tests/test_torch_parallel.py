"""The port's data parallelism on a mesh of 8 CPU shards, against the
unsharded port and the JAX package's 8-device virtual CPU mesh
(``tests/conftest.py``, as ``tests/test_parallel.py`` runs it):
``parallel/mesh.py`` (``make_mesh`` and its refusals, ``dp_mesh_for_batch``'s
message, ``pad_to_multiple``, ``shard_batch``), ``parallel/halo.py`` against a
dense stencil and JAX's, the models' ``mesh=`` (``ImageEncoder``,
``IDaRSEnsemble`` on an even and an uneven batch, ``NucleiModel`` and
``RealNucleiModel``: integers identical, floats at atol 1e-5), the training
steps through ``shard_step_over_mesh`` (losses rtol 1e-5 of the unsharded
step; JAX's sharded run at ``test_torch_fusion.py``'s replay bars), and
two processes joined by ``init_distributed`` over gloo, each taking its
rows of a fusion batch (13 and 11), against the one-process step."""

import dataclasses
import re
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from path_gene_multimodal_tpu.models import clip as jclip
from path_gene_multimodal_tpu.models import fusion as jfus
from path_gene_multimodal_tpu.models import weights_hovernext_real as jw
from path_gene_multimodal_tpu.models.convnext import ConvNeXtConfig as JConvNeXtConfig
from path_gene_multimodal_tpu.models.hovernext import HoverNeXt as JHoverNeXt
from path_gene_multimodal_tpu.models.hovernext import HoverNeXtConfig as JHoverNeXtConfig
from path_gene_multimodal_tpu.models.resnet import IDaRSEnsemble as JEnsemble
from path_gene_multimodal_tpu.models.resnet import ResNetConfig as JResNetConfig
from path_gene_multimodal_tpu.parallel import mesh as jmesh
from path_gene_multimodal_tpu.parallel.halo import sharded_stencil as j_stencil
from path_gene_multimodal_tpu.parallel.train import make_linear_probe_step as j_probe
from path_gene_multimodal_tpu.parallel.train import shard_step_over_mesh as j_shard_step
from path_gene_multimodal_tpu.pipeline import nuclei as jnuc
from path_gene_multimodal_tpu_torch.config import ConvNeXtConfig, HoverNeXtConfig
from path_gene_multimodal_tpu_torch.models import clip as tclip
from path_gene_multimodal_tpu_torch.models import fusion as tfus
from path_gene_multimodal_tpu_torch.models import weights_hovernext_real as tw
from path_gene_multimodal_tpu_torch.models.hovernext import tta_forward
from path_gene_multimodal_tpu_torch.models.resnet import IDaRSEnsemble, ResNetConfig
from path_gene_multimodal_tpu_torch.models.weights_clip import vision_state_dict_from_jax
from path_gene_multimodal_tpu_torch.models.weights_fusion import fusion_state_dict_from_jax
from path_gene_multimodal_tpu_torch.models.weights_hovernext import params_from_jax
from path_gene_multimodal_tpu_torch.models.weights_resnet import resnet_state_dict_from_jax
from path_gene_multimodal_tpu_torch.ops import watershed as tws
from path_gene_multimodal_tpu_torch.ops.components import INF
from path_gene_multimodal_tpu_torch.parallel import mesh as tmesh
from path_gene_multimodal_tpu_torch.parallel.halo import exchange_halo, sharded_stencil
from path_gene_multimodal_tpu_torch.parallel.train import make_linear_probe_step as t_probe
from path_gene_multimodal_tpu_torch.parallel.train import shard_step_over_mesh
from path_gene_multimodal_tpu_torch.pipeline import nuclei as tnuc
from test_torch_fusion import (
    LOSS_RTOL,
    VCFG,
    _assert_params_close,
    _cohort,
    _head,
    _probe_names,
)
from test_torch_resnet import _jax_variables

CPU = torch.device("cpu")
MESH = tmesh.make_mesh(devices=["cpu"] * 8)
ATOL, LOSS_SHARD_RTOL = 1e-5, 1e-5
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiles(n, size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


# -- the mesh ------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, -1, 99])
def test_make_mesh_refuses_counts_as_jax(n):
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(n)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        tmesh.make_mesh(n, devices=[CPU] * 8)


def test_make_mesh_without_cuda(monkeypatch):
    """Without a CUDA device and without ``devices`` there is no mesh (no
    fallback to the CPU); an explicit list may repeat a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    assert MESH.size == 8 and MESH.axis == "tiles" == jmesh.TILE_AXIS
    assert MESH.distinct == (CPU,)
    assert tmesh.make_mesh(3, devices=[CPU] * 8).devices == (CPU,) * 3


def test_make_mesh_checks_every_card(monkeypatch):
    """Each CUDA device of a mesh is held to compute capability 9.0, not
    device 0 alone (no card is touched: the capabilities are stubbed)."""
    caps = {0: (9, 0), 1: (8, 0)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda d: caps[torch.device(d).index])
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert tmesh.make_mesh(devices=cards[:1] * 2).size == 2
    with pytest.raises(RuntimeError, match="not a Hopper card"):
        tmesh.make_mesh(devices=cards)
    assert tmesh.make_mesh(1, devices=cards).devices == (cards[0],)


def test_dp_mesh_for_batch_message_as_jax(monkeypatch):
    """The ``--dp`` check's message is JAX's; on the CPU the mesh is the one
    CPU device, so that every batch divides it."""
    assert tmesh.dp_mesh_for_batch(12, device="cpu").devices == (CPU,)
    monkeypatch.setattr(tmesh, "local_devices", lambda kind="cuda": [CPU] * 8)
    with pytest.raises(ValueError) as want:
        jmesh.dp_mesh_for_batch(12, label="--batch-size")
    with pytest.raises(ValueError) as got:
        tmesh.dp_mesh_for_batch(12, label="--batch-size", device="cpu")
    assert str(got.value) == str(want.value)
    assert tmesh.dp_mesh_for_batch(16, device="cpu").size == 8


def test_dp_mesh_for_batch_reads_mesh_config(monkeypatch):
    """``MeshConfig.num_devices`` and ``data_axis`` size and name the
    ``--dp`` mesh; a count the devices cannot give is refused as JAX's
    ``make_mesh`` refuses it."""
    from path_gene_multimodal_tpu_torch.config import MeshConfig, default_config

    monkeypatch.setattr(tmesh, "local_devices", lambda kind="cuda": [CPU] * 8)
    assert tmesh.dp_mesh_for_batch(16, config=default_config().mesh, device="cpu").size == 8
    mesh = tmesh.dp_mesh_for_batch(12, config=MeshConfig("rows", 3), device="cpu")
    assert (mesh.size, mesh.axis) == (3, "rows")
    with pytest.raises(ValueError, match="is not a multiple of the 3-device mesh"):
        tmesh.dp_mesh_for_batch(8, config=MeshConfig(num_devices=3), device="cpu")
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        tmesh.dp_mesh_for_batch(9, config=MeshConfig(num_devices=9), device="cpu")


def test_pad_to_multiple_as_jax():
    arr = np.arange(13 * 4, dtype=np.float32).reshape(13, 4)
    want, wn = jmesh.pad_to_multiple(arr, 8)
    got, n = tmesh.pad_to_multiple(arr, 8)
    assert n == wn == 13 and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    tgot, tn = tmesh.pad_to_multiple(torch.from_numpy(arr), 8)
    assert tn == 13 and torch.equal(tgot, torch.from_numpy(want))
    same, m = tmesh.pad_to_multiple(arr[:8], 8)
    assert m == 8 and same.shape == (8, 4)


def test_shard_batch_and_gather():
    """Rows split as ``torch.tensor_split`` splits them, a 0-d leaf on every
    shard, and ``gather`` puts them back in order."""
    x = torch.arange(13 * 2).reshape(13, 2)
    parts = tmesh.shard_batch({"x": x, "n": torch.tensor(7), "y": x.numpy()}, MESH)
    assert [p["x"].shape[0] for p in parts] == [t.shape[0] for t in torch.tensor_split(x, 8)]
    assert all(int(p["n"]) == 7 for p in parts)
    assert torch.equal(tmesh.gather([p["x"] for p in parts], CPU), x)
    assert torch.equal(tmesh.gather([p["y"] for p in parts], CPU), x)


# -- halo -----------------------------------------------------------------------------


def test_exchange_halo_edges():
    bands = [torch.full((3, 2), float(i)) for i in range(3)]
    ext = exchange_halo(bands, 2)
    assert [e.shape for e in ext] == [(7, 2)] * 3
    assert ext[0][:2].eq(0).all() and ext[0][-2:].eq(1).all()  # own edge at the mesh's start
    assert ext[1][:2].eq(0).all() and ext[1][-2:].eq(2).all()
    assert ext[2][-2:].eq(2).all()
    assert all(torch.equal(a, b) for a, b in zip(exchange_halo(bands, 0), bands))


@pytest.mark.parametrize("halo", [0, 1, 2])
def test_sharded_stencil_matches_dense_and_jax(halo):
    field = np.random.default_rng(1).normal(size=(32, 16)).astype(np.float32)
    k = 2 * halo + 1
    xp = np.pad(field, ((halo, halo), (0, 0)), mode="edge")
    dense = sum(xp[i : i + 32] for i in range(k)) / k
    got = sharded_stencil(lambda x: sum(torch.roll(x, s, 0) for s in range(-halo, halo + 1)) / k,
                          MESH, halo)(torch.from_numpy(field)).numpy()
    want = np.asarray(j_stencil(lambda x: sum(jnp.roll(x, s, 0)
                                              for s in range(-halo, halo + 1)) / k,
                                jmesh.make_mesh(8), halo)(jnp.asarray(field)))
    np.testing.assert_allclose(got, dense, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-6)


# -- the models ----------------------------------------------------------------------


def _draw(shapes, seed):
    """A flax tree's leaves drawn with numpy over its shapes (flax's init
    compiles for seconds on the CPU): kernels N(0, 1/fan_in), vectors
    N(1, 0.05²) for scales and N(0, 0.05²) otherwise."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda kp, leaf: (rng.normal(0, np.prod(leaf.shape[:-1]) ** -0.5, leaf.shape)
                          if leaf.ndim > 1 else
                          ("scale" in str(kp[-1])) + rng.normal(0, 0.05, leaf.shape)
                          ).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def clip_weights():
    jcfg, tcfg = jclip.VisionConfig(**VCFG), tclip.VisionConfig(**VCFG)
    params = _draw(jax.eval_shape(jclip.VisionTower(jcfg, dtype=jnp.float32).init,
                                  jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))), 4)
    return jcfg, tcfg, params, vision_state_dict_from_jax(params, tcfg)


@pytest.mark.parametrize("n", [16, 13])
def test_image_encoder_mesh(clip_weights, n):
    jcfg, tcfg, jparams, sd = clip_weights
    tiles = _tiles(n, 32, seed=n)
    single = tclip.ImageEncoder(tcfg, sd, dtype=torch.float32, device="cpu")
    sharded = tclip.ImageEncoder(tcfg, sd, dtype=torch.float32, mesh=MESH)
    assert sharded.device == CPU and sharded._replicas[CPU] is sharded.model
    got = sharded(tiles).numpy()
    np.testing.assert_allclose(got, single(tiles).numpy(), atol=ATOL)
    if n % 8 == 0:  # JAX's mesh takes batches that divide it
        jsharded = jclip.ImageEncoder(jcfg, params=jparams, dtype=jnp.float32,
                                      mesh=jmesh.make_mesh(8))
        np.testing.assert_allclose(got, np.asarray(jsharded(tiles)), atol=ATOL)


@pytest.mark.parametrize("n", [16, 13])
def test_idars_ensemble_mesh(n):
    """16 tiles, and 13: a last batch that does not divide the mesh splits
    unevenly; the probabilities are the unsharded run's."""
    stages, width = (1, 1, 1, 1), 8
    vs = [_jax_variables(stages, width, seed=s) for s in (1, 2)]
    cfg = ResNetConfig(stages, 2, width)
    sds = [resnet_state_dict_from_jax(v, cfg) for v in vs]
    tiles = _tiles(n, 64, seed=n)
    single = IDaRSEnsemble(["msi", "hm"], sds, cfg=cfg, dtype=torch.float32, device="cpu")
    sharded = IDaRSEnsemble(["msi", "hm"], sds, cfg=cfg, dtype=torch.float32, mesh=MESH)
    got = sharded(tiles).numpy()
    assert got.shape == (2, n)
    np.testing.assert_allclose(got, single(tiles).numpy(), atol=ATOL)
    if n % 8 == 0:
        jsharded = JEnsemble(["msi", "hm"], vs, cfg=JResNetConfig(stages, 2, width),
                             dtype=jnp.float32, mesh=jmesh.make_mesh(8))
        np.testing.assert_allclose(got, np.asarray(jsharded(tiles)), atol=ATOL)


NUC_DIMS, NUC_DEC, NUC_SIZE = (16, 16, 32, 32), (32, 16, 16, 16), 64


def _same_labels_as_unsharded(single, sharded, tiles):
    lbl, tp = sharded.segment(tiles)
    lbl1, tp1 = single.segment(tiles)
    np.testing.assert_array_equal(lbl, lbl1)
    np.testing.assert_array_equal(tp, tp1)
    assert lbl.max() > 0
    assert sharded.cc_overflow_tiles(reset=True) == single.cc_overflow_tiles(reset=True) == 0
    return lbl, tp


def test_nuclei_model_mesh():
    """The canonical layout (f32, plain blocks): labels and types over the
    8-shard mesh identical to the unsharded model's; the forward's maps
    within 1e-5 of JAX's mesh run, and the port's post-processing of JAX's
    mesh maps gives JAX's mesh labels exactly."""
    enc = dict(depths=(1, 1, 1, 1), dims=NUC_DIMS)
    jcfg = JHoverNeXtConfig(encoder=JConvNeXtConfig(**enc), decoder_dims=NUC_DEC,
                            input_size=NUC_SIZE)
    tcfg = HoverNeXtConfig(encoder=ConvNeXtConfig(**enc), decoder_dims=NUC_DEC,
                           input_size=NUC_SIZE)
    params = _draw(jax.eval_shape(JHoverNeXt(jcfg, dtype=jnp.float32).init,
                                  jax.random.PRNGKey(0), jnp.zeros((1, NUC_SIZE, NUC_SIZE, 3))), 0)
    sd = params_from_jax(params, tcfg)
    kw = dict(state_dict=sd, dtype=torch.float32, tta=4, max_instances=128)
    single = tnuc.NucleiModel.build(tcfg, device="cpu", **kw)
    sharded = tnuc.NucleiModel.build(tcfg, mesh=MESH, **kw)
    assert sharded.mesh is MESH and set(sharded.replicas) == {CPU}
    tiles = _tiles(16, NUC_SIZE, seed=3)
    _same_labels_as_unsharded(single, sharded, tiles)

    jm = jnuc.NucleiModel.build(jcfg, params=params, dtype=jnp.float32, tta=4,
                                mesh=jmesh.make_mesh(8), max_instances=128)
    jnp_prob, jhv, _ = map(np.array, jm._infer(jm.params, jnp.asarray(tiles)))
    jlbl, _ = map(np.asarray, jm.segment(tiles))

    def maps(m, t):
        with torch.no_grad():
            out = tta_forward(m.model, t.float() / 255.0, tta=m.tta)
        return torch.softmax(out["np"], dim=-1)[..., 1], out["hv"]

    np_prob, hv = sharded.map_shards(maps, torch.from_numpy(tiles))
    np.testing.assert_allclose(np_prob.numpy(), jnp_prob, atol=ATOL)
    np.testing.assert_allclose(hv.numpy(), jhv, atol=ATOL)
    lbl, _ = tws.hover_instances_batch(torch.from_numpy(jnp_prob), torch.from_numpy(jhv))
    np.testing.assert_array_equal(torch.where(lbl < INF, lbl, 0).numpy(), jlbl)


@pytest.mark.parametrize("inst", [5, 3])
def test_real_nuclei_model_mesh(inst):
    """The published layout, both instance decoders (f32): as above, the
    head maps of the port's mesh run within 1e-5 of JAX's, and its decoder
    on JAX's mesh maps gives JAX's mesh labels exactly."""
    np_sd = tw.synthesize_real_state_dict((1, 1, 1, 1), NUC_DIMS, NUC_DEC,
                                          {"inst": inst, "ct": 6}, seed=inst)
    cfg, sd = tw.normalize_real_state_dict(np_sd)
    cfg = dataclasses.replace(cfg, input_size=NUC_SIZE)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    # the seeded heads' interior probability stays under the default seed
    # threshold of 0.8: both packages' three-class decoders take 0.3 here
    thr = dict(seed_threshold=0.3)
    kw = dict(state_dict=sd, dtype=torch.float32, tta=4, max_instances=128, **thr)
    single = tnuc.RealNucleiModel.build(cfg, device="cpu", **kw)
    sharded = tnuc.RealNucleiModel.build(cfg, mesh=MESH, **kw)
    tiles = _tiles(16, NUC_SIZE, seed=inst)
    _same_labels_as_unsharded(single, sharded, tiles)

    jcfg, variables, _ = jw.convert_real_hovernext(np_sd)
    jcfg = dataclasses.replace(jcfg, input_size=NUC_SIZE)
    jm = jnuc.RealNucleiModel.build(jcfg, params=variables, dtype=jnp.float32, tta=4,
                                    mesh=jmesh.make_mesh(8), max_instances=128, **thr)
    jlogits, _ = map(np.array, jm._infer(jm.params, jnp.asarray(tiles)))
    jlbl, _ = map(np.asarray, jm.segment(tiles))

    def head(m, t):
        with torch.no_grad():
            return m.forward(t.float() / 255.0)[m.inst_head]

    logits = sharded.map_shards(head, torch.from_numpy(tiles))
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=ATOL)
    lbl, _ = sharded.decode(torch.from_numpy(jlogits))
    np.testing.assert_array_equal(torch.where(lbl < INF, lbl, 0).numpy(), jlbl)


# -- training ---------------------------------------------------------------------------


def _probe_setup(train_encoder, lr=1e-3):
    jcfg, tcfg = jclip.VisionConfig(**VCFG), tclip.VisionConfig(**VCFG)
    jtower = jclip.VisionTower(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(9)
    jparams = _draw(jax.eval_shape(jtower.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))),
                    9)
    tiles = rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    pixels = np.array(jclip.preprocess_tiles(jnp.asarray(tiles)))
    labels = rng.integers(0, 5, 16).astype(np.int32)
    w = (rng.normal(size=(16, 5)) * 0.02).astype(np.float32)
    tower = tclip.VisionTower(tcfg, dtype=torch.float32)
    tower.load_state_dict(vision_state_dict_from_jax(jparams, tcfg))
    t_init, t_step = t_probe(tower, 16, 5, learning_rate=lr, train_encoder=train_encoder,
                             device="cpu", mesh=MESH)
    state = t_init(torch.Generator().manual_seed(1))
    state["params"]["head.w"] = torch.from_numpy(w)
    j_init, j_step = j_probe(lambda p, px: jtower.apply(p, px), jparams, feature_dim=16,
                             num_classes=5, learning_rate=lr, train_encoder=train_encoder)
    jstate = j_init(jax.random.PRNGKey(1))
    jstate["params"]["head"]["w"] = jnp.asarray(w)
    grads = jax.jit(jax.grad(lambda p: optax.softmax_cross_entropy_with_integer_labels(
        jtower.apply(p.get("encoder", jparams), pixels) @ p["head"]["w"] + p["head"]["b"],
        labels).mean()))
    return (state, t_step), (jstate, j_step), grads, pixels, labels, tcfg


@pytest.mark.parametrize("train_encoder", [False, True])
def test_linear_probe_sharded(train_encoder):
    """Three steps over the 8-shard mesh: losses within rtol 1e-5 of the
    unsharded port step's, and JAX's sharded run's at the replay bars."""
    lr, steps = 1e-3, 3
    (state, step), (jstate, jstep), jgrad, pixels, labels, tcfg = _probe_setup(train_encoder, lr)
    run, sstate = shard_step_over_mesh(step, MESH, state)
    jrun, jstate = j_shard_step(jstep, jmesh.make_mesh(8), jstate)
    losses, slosses, jlosses, grads = [], [], [], {}
    for _ in range(steps):
        for k, v in _probe_names(jgrad(jstate["params"]), tcfg).items():
            grads[k] = np.minimum(grads.get(k, np.inf), np.abs(v))
        state, loss = step(state, pixels, labels)
        sstate, sloss = run(sstate, pixels, labels)
        jstate, jloss = jrun(jstate, pixels, labels)
        losses.append(float(loss))
        slosses.append(float(sloss))
        jlosses.append(float(jloss))
    np.testing.assert_allclose(slosses, losses, rtol=LOSS_SHARD_RTOL)
    np.testing.assert_allclose(slosses, jlosses, rtol=LOSS_RTOL)
    assert slosses[-1] < slosses[0]
    got = {k: v.numpy() for k, v in sstate["params"].items()}
    _assert_params_close(got, _probe_names(jstate["params"], tcfg), grads, lr, steps)
    _assert_params_close(got, {k: v.numpy() for k, v in state["params"].items()}, grads, lr,
                         steps)


def test_fusion_trainer_sharded_matches_unsharded_and_jax():
    """At dropout 0 against JAX's sharded run (replay bars) and the
    unsharded port step; at dropout 0.1 against the unsharded step, whose
    masks the shards take row by row (JAX's masks are its own PRNG's)."""
    lr, steps = 1e-2, 4
    kw = dict(num_outputs=2, proj_dim=16, hidden=16, dropout=0.0)
    jmodel, jp, model = _head(32, 20, 6, **kw)
    hist, genes, labels = _cohort(64, 32, 20, 7)
    jstate, jstep, _ = jfus.make_fusion_trainer(jmodel, 32, 20, lr)
    jp = jax.tree.map(jnp.asarray, jp)
    jstate = {"params": jp, "opt": optax.adamw(lr).init(jp), "rng": jstate["rng"]}
    jrun, jstate = j_shard_step(jstep, jmesh.make_mesh(8), jstate)
    state, step, _ = tfus.make_fusion_trainer(model, 32, 20, lr, device="cpu")
    state = dict(state, params=fusion_state_dict_from_jax(jax.tree.map(np.asarray, jp)))
    run, sstate = shard_step_over_mesh(step, MESH, state)
    jgrad = jax.jit(jax.grad(lambda p: optax.softmax_cross_entropy_with_integer_labels(
        jmodel.apply(p, hist, genes), labels).mean()))
    losses, slosses, jlosses, grads = [], [], [], {}
    for _ in range(steps):
        for k, v in fusion_state_dict_from_jax(jgrad(jstate["params"])).items():
            grads[k] = np.minimum(grads.get(k, np.inf), np.abs(v.numpy()))
        state, loss = step(state, hist, genes, labels)
        sstate, sloss = run(sstate, hist, genes, labels)
        jstate, jloss = jrun(jstate, hist, genes, labels)
        losses.append(float(loss))
        slosses.append(float(sloss))
        jlosses.append(float(jloss))
    np.testing.assert_allclose(slosses, losses, rtol=LOSS_SHARD_RTOL)
    np.testing.assert_allclose(slosses, jlosses, rtol=LOSS_RTOL)
    got = {k: v.numpy() for k, v in sstate["params"].items()}
    want = {k: v.numpy() for k, v in fusion_state_dict_from_jax(jstate["params"]).items()}
    _assert_params_close(got, want, grads, lr, steps)

    model = tfus.FusionHead(32, 20, **dict(kw, dropout=0.1))
    state, step, _ = tfus.make_fusion_trainer(model, 32, 20, lr, seed=3, device="cpu")
    run, sstate = shard_step_over_mesh(step, MESH, state)
    for _ in range(steps):
        state, loss = step(state, hist, genes, labels)
        sstate, sloss = run(sstate, hist, genes, labels)
        assert float(sloss) == pytest.approx(float(loss), rel=LOSS_SHARD_RTOL)
        assert torch.equal(sstate["rng"], state["rng"])  # the same draws, once a step
    for k, v in state["params"].items():
        np.testing.assert_allclose(sstate["params"][k].numpy(), v.numpy(), atol=ATOL)


_DIST_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from path_gene_multimodal_tpu_torch.models import fusion as tfus
    from path_gene_multimodal_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from path_gene_multimodal_tpu_torch.parallel.train import shard_step_over_mesh
    pid, n, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    init_distributed(f"localhost:{{port}}", num_processes=n, process_id=pid)
    assert dist.get_backend() == "gloo" and dist.get_world_size() == n
    got = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(got, torch.tensor([pid]))
    assert [int(g) for g in got] == list(range(n)), got
    rng = np.random.default_rng(7)
    hist = rng.normal(size=(24, 12)).astype(np.float32)
    genes = rng.normal(size=(24, 6)).astype(np.float32)
    labels = (hist[:, 0] > 0).astype(np.int64)
    rows = [slice(0, 13), slice(13, 24)][pid]  # uneven: the ranks' row counts differ
    model = tfus.FusionHead(12, 6, proj_dim=8, hidden=8, dropout=0.1)
    state, step, _ = tfus.make_fusion_trainer(model, 12, 6, 1e-2, seed=3, device="cpu")
    run, state = shard_step_over_mesh(step, make_mesh(devices=["cpu", "cpu"]), state)
    losses = []
    for _ in range(3):
        state, loss = run(state, hist[rows], genes[rows], labels[rows])
        losses.append(float(loss))
    torch.save({{"losses": losses, "params": state["params"]}}, out)
    dist.destroy_process_group()
    print(f"proc {{pid}}: OK", flush=True)
""")


def test_two_process_gloo_fusion_step(tmp_path):
    """Two CPU processes joined by ``init_distributed`` (gloo): an
    all-gather, then three fusion steps at dropout 0.1, each process on its
    rows of the batch (13 and 11) over a 2-shard mesh of its own; every
    step's loss and the parameters equal the one-process step's."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(_DIST_WORKER.format(repo=str(ROOT)))
    outs = [tmp_path / f"rank{i}.pt" for i in range(2)]
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), "2", str(port), str(outs[i])],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"proc {i} rc={p.returncode}:\n{log[-2000:]}"
        assert f"proc {i}: OK" in log

    rng = np.random.default_rng(7)
    hist = rng.normal(size=(24, 12)).astype(np.float32)
    genes = rng.normal(size=(24, 6)).astype(np.float32)
    labels = (hist[:, 0] > 0).astype(np.int64)
    model = tfus.FusionHead(12, 6, proj_dim=8, hidden=8, dropout=0.1)
    state, step, _ = tfus.make_fusion_trainer(model, 12, 6, 1e-2, seed=3, device="cpu")
    losses = []
    for _ in range(3):
        state, loss = step(state, hist, genes, labels)
        losses.append(float(loss))
    for out in outs:
        got = torch.load(out)
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_SHARD_RTOL)
        for k, v in state["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=ATOL)
