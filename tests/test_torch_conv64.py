"""K8 and K11 on the card's 64-channel conv kernel (``csrc/conv64.cu``),
on the CPU: its launch geometry, K11's per-phase decomposition, the
block-diagonal head it requires, and the widths the card's kernels take.

- ``StripTiling``: played out block by block as the kernel runs it
  (``worker_schedule``), every output pixel of every phase lies in exactly
  one step; each step finds in its worker's ring the input rows it reads, each
  copied from the right image, row and columns; convs over those rows,
  zero outside the image, reassemble the conv of the whole map; the shared
  memory fits a block.
- K11's kernel decomposition (each parity phase a 64-channel conv with its
  diagonal head block, as the launcher hands them over) equals
  ``composite_final_heads_plain`` on ``k11_weights`` and the Pallas kernel
  in interpret mode, within 2 bf16 ulp + 1e-3 (the head's f32 sums run in
  another order); with the head blocks of the wrong phases it does not.
- K11's per-phase route is taken only for a head the caller states
  block-diagonal (the model's call vouches for the head ``k11_weights``
  builds); for a full head the per-phase decomposition is wrong, and the
  call takes K7's any route, which multiplies the whole head.
- A last decoder width of 96 takes K7's any route in every final-stage
  kernel; HoverNeXt-tiny's widths keep the kernels' own routes.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from path_gene_multimodal_tpu.models import hovernext_fn as jfn
from path_gene_multimodal_tpu.ops.pallas import decoder as jdec
from path_gene_multimodal_tpu_torch.config import HOVERNEXT_TINY
from path_gene_multimodal_tpu_torch.models import hovernext_fn as tfn
from path_gene_multimodal_tpu_torch.ops import decoder as tdec
from test_torch_decoder import _assert_elementwise, _final_params, _j_block_diag, _normal
from test_torch_shape_refusals import _kernel_tilings

T = torch.from_numpy

# (batch, h, w, phases): K8 at the model's tile (one image of a 128-tile
# batch) and its ragged checks; K11 at the model's half resolution and its
# ragged checks
SHAPES = [(2, 256, 256, 1), (3, 32, 70, 1), (2, 64, 10, 1),
          (2, 128, 128, 4), (3, 34, 34, 4), (2, 6, 10, 4)]


def _ids(s):
    return f"{s[0]}x{s[1]}x{s[2]}-p{s[3]}"


def _play(geo: tdec.StripTiling):
    """Runs every worker's schedule: its ring's slots as the copies fill
    them; returns the steps, each with the (image, input row, x0) of the
    rows it found at its window's positions."""
    steps = []
    for block in range(geo.grid):
        for group in range(geo.groups):
            slots = {}
            for ev in geo.worker_schedule(block, group):
                if ev[0] == "copy":
                    _, pos, img, y, x0 = ev
                    slots[pos % geo.ring] = (pos, img, y, x0)
                else:
                    _, pos, img, oy0, x0 = ev
                    rows = [slots.get((pos + i) % geo.ring) for i in range(geo.step_rows + 2)]
                    steps.append((block % geo.phases, img, oy0, x0, pos, rows))
    return steps


@pytest.mark.parametrize("n_sm", [132, 12])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_strip_tiling_covers_every_pixel_and_tap(shape, n_sm):
    bsz, h, w, phases = shape
    geo = tdec.StripTiling(bsz, h, w, phases=phases, n_sm=n_sm)
    assert geo.grid % phases == 0 and 0 < geo.grid // phases * geo.groups < geo.n_items + 2
    assert geo.grid <= n_sm
    assert geo.smem_bytes == (230_528 if phases > 1 else 227_456) <= tdec.SMEM_PER_BLOCK
    assert geo.launch_args() == (32, 64, 4, 8, geo.grid, geo.smem_bytes)

    covered = np.zeros((phases, bsz, h, w), np.int32)
    for phase, img, oy0, x0, pos, rows in _play(geo):
        for i, got in enumerate(rows):
            assert got is not None and got[0] == pos + i, (phase, img, oy0, x0, i, got)
            assert got[1:] == (img, oy0 - 1 + i, x0), (got, img, oy0, x0, i)
        covered[phase, img, oy0 : oy0 + geo.step_rows, x0 : x0 + geo.strip_w] += 1
    np.testing.assert_array_equal(covered, 1)


@pytest.mark.parametrize("shape", [(1, 32, 70), (2, 34, 34), (1, 6, 10)], ids=str)
def test_strip_tiling_rows_reassemble_the_conv(shape):
    """Each step's conv over the rows the ring holds (66 columns from
    x0 - 1, zero outside the image) equals the SAME conv of the whole map
    where the step writes."""
    bsz, h, w = shape
    geo = tdec.StripTiling(bsz, h, w, n_sm=4)
    rng = np.random.default_rng(h * 100 + w)
    x = _normal(rng, (bsz, h, w, 3))
    wk = _normal(rng, (3, 3, 3, 4), 0.2)
    whole = tdec._conv3x3(T(x), T(wk)).numpy()
    xp = np.zeros((bsz, h + 2 + geo.step_rows, w + 2 + geo.strip_w, 3), np.float32)
    xp[:, 1 : h + 1, 1 : w + 1] = x
    tiled = np.full((bsz, h, w, 4), np.nan, np.float32)
    for _, img, oy0, x0, _, rows in _play(geo):
        # row y, columns x0 - 1 .. x0 + 64 of the zero-padded input
        win = np.stack([xp[img, y + 1, x0 : x0 + geo.strip_w + 2] for _, _, y, _ in rows])
        conv = torch.nn.functional.conv2d(T(win).permute(2, 0, 1)[None],
                                          T(wk).permute(3, 2, 0, 1))[0].permute(1, 2, 0).numpy()
        hh, ww = min(geo.step_rows, h - oy0), min(geo.strip_w, w - x0)
        tiled[img, oy0 : oy0 + hh, x0 : x0 + ww] = conv[:hh, :ww]
    np.testing.assert_allclose(tiled, whole, atol=1e-5, rtol=0)


def _k11_inputs(seed):
    rng = np.random.default_rng(seed)
    p = _final_params(rng, 8, 8)
    x = _normal(rng, (2, 9, 7, 8))
    return p, x


def _torch_params(p):
    return {k: {n: T(v) for n, v in d.items()} for k, d in p.items()}


@pytest.mark.parametrize("exact_gelu", [False, True], ids=["tanh", "erf"])
def test_k11_phase_decomposition_matches_plain_and_pallas(exact_gelu):
    p, x = _k11_inputs(130 + exact_gelu)
    wc, bias4, wh_bd, bh4 = tfn.k11_weights(_torch_params(p), torch.float32)[:4]
    got = tdec.composite_final_heads_by_phase(T(x), wc, bias4, wh_bd, bh4, exact_gelu)
    plain = tdec.composite_final_heads_plain(T(x), wc, bias4, wh_bd, bh4, exact_gelu)
    _assert_elementwise(got.float().numpy(), plain.float().numpy())

    jp = jax.tree.map(jnp.asarray, p)
    jwc, jb4, wcat, bcat = jfn._lowres_head_weights(jp, jp["final_conv"], jnp.float32)
    jwh, jbh = _j_block_diag(wcat, bcat)
    ref = jdec.composite_final_heads(jnp.asarray(x), jwc, jb4, jwh, jbh, exact_gelu=exact_gelu,
                                     interpret=True)
    _assert_elementwise(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_k11_phase_decomposition_sees_permuted_head_blocks():
    """With a different head block per phase, applying the blocks to the
    wrong phases (the mutant ``chip_smoke.py`` holds K11 against) fails
    the tolerance that the right order passes."""
    p, x = _k11_inputs(132)
    rng = np.random.default_rng(133)
    wc, bias4 = tfn.k11_weights(_torch_params(p), torch.float32)[:2]
    wh_bd = torch.block_diag(*(T(_normal(rng, (8, 10), 0.3)) for _ in range(4)))
    bh4 = T(_normal(rng, 40, 0.1))
    plain = tdec.composite_final_heads_plain(T(x), wc, bias4, wh_bd, bh4).float().numpy()
    _assert_elementwise(
        tdec.composite_final_heads_by_phase(T(x), wc, bias4, wh_bd, bh4).float().numpy(), plain)
    bad = tdec.composite_final_heads_by_phase(T(x), wc, bias4, wh_bd, bh4,
                                              head_of=(1, 2, 3, 0)).float().numpy()
    with pytest.raises(AssertionError):
        _assert_elementwise(bad, plain)


def test_k11_full_head_leaves_the_per_phase_route():
    """A head with nonzero blocks off its diagonal: the per-phase
    decomposition (the conv64 route's) no longer equals the plain version,
    so such a call takes the wide head route with the whole head (one phase
    of 4 cout, 4 n_out), as every call that does not state
    ``block_diagonal=True`` does; the head ``k11_weights`` builds passes
    either way."""
    p, x = _k11_inputs(134)
    wc, bias4, wh_bd, bh4 = tfn.k11_weights(_torch_params(p), torch.float32)[:4]
    per_phase = lambda wh: tdec.composite_final_heads_by_phase(  # noqa: E731
        T(x), wc, bias4, wh, bh4).float().numpy()
    plain = lambda wh: tdec.composite_final_heads_plain(  # noqa: E731
        T(x), wc, bias4, wh, bh4).float().numpy()
    _assert_elementwise(per_phase(wh_bd), plain(wh_bd))
    full = wh_bd.clone()
    full[: wh_bd.shape[0] // 4, wh_bd.shape[1] // 4 :] = 0.5
    with pytest.raises(AssertionError):
        _assert_elementwise(per_phase(full), plain(full))
    geo = lambda bd: tdec.StripTiling(2, 9, 7, phases=4, n_out=10, block_diagonal=bd)  # noqa: E731
    assert (geo(True).route, geo(False).route) == ("conv64", "wide")
    assert geo(False).any_geo.raw and geo(False).any_geo.cout == 256
    assert (geo(False).head_geo.phases, geo(False).head_geo.cout) == (1, 256)


def test_model_path_vouches_for_its_head(monkeypatch):
    """The model's K11 call states that its head (from ``k11_weights``) is
    block-diagonal, so the card runs it without the device check; a direct
    call checks by default."""
    seen = []
    monkeypatch.setattr(tfn, "composite_final_heads",
                        lambda *a, **kw: seen.append(kw) or tdec.composite_final_heads(*a, **kw))
    p, x = _k11_inputs(135)
    tp = _torch_params(p)
    tfn._final_heads_lowres_pallas(tp, T(x), torch.float32, False,
                                   tfn.k11_weights(tp, torch.float32))
    assert seen and all(kw.get("block_diagonal") is True for kw in seen), seen
    sig = inspect.signature(tdec.composite_final_heads)
    assert sig.parameters["block_diagonal"].default is False


@pytest.mark.parametrize("option", ["fused_decoder", "pallas", "heads", "k9"])
def test_last_width_96_takes_the_any_route(option):
    """A last decoder width of 96 (K7's fixed widths all) puts K8 under
    ``fused_decoder`` on K7's any route (its weights would stream through
    the wide kernel's ring), K9, K10 and K11 on the wide route;
    HoverNeXt-tiny's widths keep every kernel on its own."""
    cfg = dataclasses.replace(HOVERNEXT_TINY, decoder_dims=(384, 192, 96, 96))
    routes = [geo.route for _, geo in _kernel_tilings(cfg, option)]
    assert routes[-1] == ("any" if option == "fused_decoder" else "wide"), routes
    assert all(r == "fixed" for r in routes[:-1]), routes
    assert "any" not in [geo.route for _, geo in _kernel_tilings(HOVERNEXT_TINY, option)]
