"""Multimodal fusion walkthrough, in the port: the repo-namesake capability
(BASELINE.json configs[4]: "Multimodal fusion: slide-level embeddings +
gene-expression vectors" over a cohort loop).

The JAX package's ``examples/fusion_train_demo.py`` with its sizes, steps,
printed lines and exit codes. It synthesizes a small cohort end to end, no
external data needed:

1. per-slide tile-embedding matrices (the ``<slide>_features.h5`` payload
   the embedding stage writes) → slide vectors via MIL attention pooling
   (a seeded ``AttentionPool``);
2. a genes × samples expression CSV (typical TCGA export layout) →
   ``GeneExpressionTable`` (log1p + z-score);
3. ``FusionHead`` training with the functional step, a checkpoint at epoch
   60 (``core.checkpoints.save_params``), a restore that must equal the
   live epoch-60 state bit for bit, one resumed step that must equal the
   live run's next step bit for bit (dropout included), and held-out
   evaluation.

The synthetic labels depend on BOTH modalities: the run passes (exit 0)
only if the held-out accuracy beats the single-modality oracle (~75%);
exit 1 if it does not or a check fails, 2 without a GPU unless
``--device cpu``. The cohort data are numpy draws from seed 0, as in JAX;
the pool's and the head's seeded weights are the port's own draws.

Usage:
    python -m path_gene_multimodal_tpu_torch.cli.fusion_train_demo [out_dir] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default="fusion_demo_out")
    ap.add_argument("--device", default="cuda", help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import pandas as pd
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    from path_gene_multimodal_tpu_torch.core.checkpoints import (
        flatten_params,
        load_params,
        save_params,
    )
    from path_gene_multimodal_tpu_torch.models.fusion import (
        AttentionPool,
        FusionHead,
        GeneExpressionTable,
        flax_init,
        make_fusion_trainer,
    )
    from path_gene_multimodal_tpu_torch.ops.cuda import exact_f32

    rng = np.random.default_rng(0)
    n_slides, tiles_per_slide, emb_dim, n_genes = 960, 100, 32, 24

    # --- 1. cohort of per-slide tile embeddings → slide vectors -----------
    print(f"[1] {n_slides} slides × {tiles_per_slide} tile embeddings "
          f"→ MIL attention pooling ...")
    slide_signal = rng.normal(size=(n_slides, emb_dim)).astype(np.float32)
    tile_stacks = (
        slide_signal[:, None, :]
        + 0.8 * rng.normal(size=(n_slides, tiles_per_slide, emb_dim)).astype(np.float32)
    )
    pool = AttentionPool(emb_dim, hidden=32)
    pool.load_state_dict(flax_init(pool, torch.Generator().manual_seed(0)))
    pool = pool.to(device)
    with torch.no_grad(), exact_f32():
        slide_vecs = pool(torch.from_numpy(tile_stacks).to(device)).cpu().numpy()

    # --- 2. gene expression table (genes × samples CSV round-trip) --------
    print("[2] genes × samples expression CSV → GeneExpressionTable ...")
    sample_ids = [f"TCGA-{i:03d}" for i in range(n_slides)]
    gene_raw = np.exp(rng.normal(size=(n_genes, n_slides))).astype(np.float32)
    csv_path = out_dir / "expression.csv"
    pd.DataFrame(
        gene_raw, index=[f"GENE{g}" for g in range(n_genes)], columns=sample_ids
    ).to_csv(csv_path)
    table = GeneExpressionTable.from_csv(csv_path)
    genes = np.stack([table.vector_for(s) for s in sample_ids])

    # labels truly need BOTH modalities
    labels = ((slide_signal[:, 0] + genes[:, 0]) > 0).astype(np.int32)

    # --- 3. train/eval split, training, checkpoint + resume ---------------
    n_train = 720
    print(f"[3] training FusionHead on {n_train} slides, "
          f"evaluating on {n_slides - n_train} ...")
    model = FusionHead(emb_dim, genes.shape[1], num_outputs=2, proj_dim=16, hidden=16,
                       dropout=0.1)
    state, step, predict = make_fusion_trainer(model, emb_dim, genes.shape[1], 3e-3,
                                               device=device)
    h_tr, g_tr, y_tr = (torch.from_numpy(a[:n_train]).to(device)
                        for a in (slide_vecs, genes, labels))
    ckpt = ckpt_state = after_ckpt = None
    for epoch in range(120):
        state, loss = step(state, h_tr, g_tr, y_tr)
        if epoch == 60:
            ckpt = save_params(state, out_dir / "fusion_train_state")
            ckpt_state = state  # kept to prove the restore is bit-exact
            print(f"    epoch {epoch}: loss {float(loss):.3f} "
                  f"(checkpoint → {ckpt.name})")
        elif epoch % 40 == 0:
            print(f"    epoch {epoch}: loss {float(loss):.3f}")
        if epoch == 61:
            after_ckpt = state  # the live run's step after the checkpoint

    probs = predict(state, slide_vecs[n_train:], genes[n_train:]).cpu().numpy()
    acc = float(((probs[:, 1] > 0.5).astype(int) == labels[n_train:]).mean())
    # single-modality ceiling: the best predictor that ignores genes
    acc_hist = float(((slide_signal[n_train:, 0] > 0).astype(int)
                      == labels[n_train:]).mean())
    print(f"    held-out accuracy: {acc:.2f} "
          f"(hist-only oracle: {acc_hist:.2f} — fusion must beat it)")

    # resume from the mid-run checkpoint: the restore must be BIT-EXACT vs
    # the live epoch-60 state (params, optimiser state, dropout generator),
    # and its next step equal to the live run's
    def differing(a, b) -> int:
        fa, fb = flatten_params(a), flatten_params(b)
        return sum(not torch.equal(fa[k].cpu(), fb[k].cpu()) for k in fa)

    restored = load_params(ckpt, like=state)
    bad = differing(restored, ckpt_state)
    if bad:
        print(f"FUSION DEMO FAILED: restore not bit-exact ({bad} leaves differ)")
        return 1
    restored, loss = step(restored, h_tr, g_tr, y_tr)
    bad = differing(restored, after_ckpt)
    if bad:
        print(f"FUSION DEMO FAILED: resumed step not bit-exact ({bad} leaves differ)")
        return 1
    print(f"[4] resumed from checkpoint (bit-exact restore verified), "
          f"next-step loss {float(loss):.3f}")

    if acc <= acc_hist:  # the stated success criterion: beat the oracle
        print("FUSION DEMO WEAK (no gain over the single-modality oracle)")
        return 1
    print("FUSION DEMO OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
