"""End-to-end training driver.

Counterpart of ``repro.launch.train``, on the GPU unless told otherwise:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --smoke --steps 50 --device cpu

The flags are the JAX driver's plus ``--device`` (default: the CUDA
device, raising without one).  The config comes from ``--arch`` (full or
``--smoke``), the data from the deterministic pipeline (the JAX
package's batches for the same ``--seed``), prefetched to the device;
checkpoints in the JAX package's format every ``--ckpt-every`` steps
(async), at the end, pruned to 3, and a run given ``--ckpt-dir`` resumes
from its newest checkpoint.  Weights are drawn from a ``torch.Generator``
seeded with ``--seed`` (they differ from ``jax.random``'s).  ``main``
returns the JAX ``main``'s dict.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs.base import ShapeConfig
from ..configs.registry import get_config, smoke_config
from ..core.comm import resolve_device
from ..data.pipeline import Prefetcher, synth_batch
from ..models.model import LModel
from ..models.param import leaves
from ..train import checkpoint as ckpt
from ..train import optimizer as O
from ..train.train_loop import make_train_step


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-8b")
    p.add_argument("--smoke", action="store_true",
                   help="reduced same-family config (CPU-runnable)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=0,
                   help="override d_model (e.g. ~100M-param demo)")
    p.add_argument("--layers", type=int, default=0)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.width:
        cfg = dataclasses.replace(
            cfg, d_model=args.width,
            d_ff=args.width * 4 if cfg.d_ff else 0,
            head_dim=max(args.width // max(cfg.n_heads, 1), 8)
            if cfg.n_heads else 0,
            d_inner=args.width * 2 if cfg.d_inner else 0)
    if args.layers:
        pat = len(cfg.attn_pattern)
        cfg = dataclasses.replace(cfg, n_layers=max(pat, args.layers))
    cfg = dataclasses.replace(cfg, microbatch_seqs=min(
        cfg.microbatch_seqs, args.batch))
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    device = resolve_device(args.device)

    model = LModel(cfg, max_seq=args.seq if cfg.pos_emb == "learned" else 0,
                   device=device,
                   generator=torch.Generator(device=device).manual_seed(
                       args.seed))
    params = model.param_tree()
    n_params = sum(t.numel() for _, t in leaves(params))
    ocfg = O.OptConfig(peak_lr=args.lr, warmup_steps=min(20, args.steps // 5),
                       decay_steps=max(args.steps, 2),
                       algorithm=cfg.optimizer,
                       state_dtype=cfg.opt_state_dtype)
    opt_state = O.init_state(ocfg, params)
    step_fn = make_train_step(model, ocfg)

    start = 0
    if args.ckpt_dir:
        out = ckpt.restore_latest(args.ckpt_dir,
                                  {"params": params, "opt": opt_state},
                                  device=device)
        if out is not None:
            (tree, start) = out
            with torch.no_grad():
                for (_, dst), (_, src) in zip(leaves(params),
                                              leaves(tree["params"])):
                    dst.copy_(src)
            opt_state = tree["opt"]
            print(f"resumed from step {start}")

    pf = Prefetcher(lambda s: synth_batch(cfg, shape, s, seed=args.seed),
                    start_step=start, device=device)
    writer = None
    losses = []
    t0 = time.perf_counter()
    try:
        for step, batch in pf:
            if step >= args.steps:
                break
            opt_state, metrics = step_fn(opt_state, batch)
            losses.append(float(metrics["loss"]))
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.perf_counter() - t0
                tput = (step - start + 1) * args.batch * args.seq \
                    / max(dt, 1e-9)
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} {tput:,.0f} tok/s",
                      flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                if writer is not None:
                    writer.join()
                writer = ckpt.save(args.ckpt_dir, step + 1,
                                   {"params": params, "opt": opt_state},
                                   asynchronous=True)
    finally:
        pf.close()
        if writer is not None:
            writer.join()
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, {"params": params,
                                              "opt": opt_state})
        ckpt.prune(args.ckpt_dir, keep=3)
    return {"params": n_params, "first_loss": losses[0],
            "last_loss": losses[-1], "steps": len(losses)}


if __name__ == "__main__":
    out = main()
    print(f"done: {out['steps']} steps, {out['params']:,} params, "
          f"loss {out['first_loss']:.3f} → {out['last_loss']:.3f}")
