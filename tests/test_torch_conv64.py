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
- A head with a nonzero off-diagonal block is refused where the card's
  path checks it (``check_block_diagonal``); the model's call vouches for
  the head ``k11_weights`` builds and skips the device check.
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
from path_gene_multimodal_tpu_torch.models.hovernext import kernel_width_errors
from path_gene_multimodal_tpu_torch.ops import decoder as tdec
from test_torch_decoder import _assert_elementwise, _final_params, _j_block_diag, _normal

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


def test_off_diagonal_head_is_refused():
    wh_bd = tfn.k11_weights(_torch_params(_k11_inputs(134)[0]), torch.float32)[2]
    tdec.check_block_diagonal(wh_bd)  # what k11_weights builds passes
    wh_bd[0, 39] = 0.5
    with pytest.raises(ValueError, match="off its diagonal"):
        tdec.check_block_diagonal(wh_bd)
    dense = torch.full((256, 40), 0.1)
    with pytest.raises(ValueError, match="off its diagonal"):
        tdec.check_block_diagonal(dense)
    with pytest.raises(ValueError, match="grid of blocks"):
        tdec.check_block_diagonal(torch.zeros(256, 42))
    with torch.inference_mode():
        tdec.check_block_diagonal(torch.block_diag(*[torch.ones(64, 10)] * 4))
    # zeros off the diagonal even where the head holds no finite number
    wcat = torch.full((8, 10), float("nan"))
    bd = tfn._block_diag_heads(wcat, torch.zeros(10))[0]
    tdec.check_block_diagonal(bd)


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
def test_kernel_width_errors_name_k8_and_k11_at_last_width_96(option):
    """A last decoder width of 96 (which K7 takes) is refused by K8 under
    ``fused_decoder`` and by K11 under ``"pallas"`` (as by K9 and K10);
    HoverNeXt-tiny passes."""
    cfg = dataclasses.replace(HOVERNEXT_TINY, decoder_dims=(384, 192, 96, 96))
    fused_decoder = option == "fused_decoder"
    final = {"pallas": "pallas", "heads": "heads", "k9": True}.get(option, False)
    errs = kernel_width_errors(cfg, fused_decoder, final)
    kernel = {"fused_decoder": "K8", "pallas": "K11", "heads": "K10", "k9": "K9"}[option]
    assert len(errs) == 1 and kernel in errs[0] and "got 96" in errs[0], errs
    if option == "fused_decoder":
        assert "K7/K8" in errs[0]
    assert kernel_width_errors(HOVERNEXT_TINY, fused_decoder, final) == []
