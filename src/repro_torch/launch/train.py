"""Training launcher of the port: the Trainer on the synthetic bigram
stream, on the GPU (``--device cpu`` runs the plain versions).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --reduced --device cpu --steps 3 --batch 4 --seq 32

``--reduced`` takes the arch's smoke config; ``--arch`` takes the
serving archs and bert-base, as the reference's launcher does (the vlm,
encdec and MLA archs raise: their training is not ported yet).  A MoE
arch (granite-moe-3b-a800m) trains on CE + 0.01 x its load-balance loss,
and ``--layers`` cuts the depth (full-width granite's parameters,
gradients and two AdamW moments alone come to ~62 GB at 32 layers).
The recurrent archs train through their scans' backward kernels:

    python -m repro_torch.launch.train --arch rwkv6-1.6b --batch 2 \
        --seq 2048 --data-vocab 8192 --steps 2
    python -m repro_torch.launch.train --arch jamba-v0.1-52b --layers 1 \
        --batch 1 --seq 2048 --data-vocab 8192 --steps 2

(full-width jamba at depth 2 adds a 16-expert MoE layer, ~105 GB with
AdamW).  The stream's bigram table
is (vocab, vocab) float32, built on the host: at a full 150k vocabulary
that is ~92 GB, so a full-width run passes ``--data-vocab`` (token ids
then stay below it).  Checkpoints go to ``--ckpt`` (default: a
directory under the temporary directory).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.train import Trainer
from repro_torch.train.step import check_train_arch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=registry.ARCH_IDS + ["bert-base"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-feasible)")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--fsdp", action="store_true",
                    help="not ported yet (raises)")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-vocab", type=int, default=0,
                    help="vocabulary of the synthetic stream (default: the "
                         "model's)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu' (plain versions)")
    args = ap.parse_args()

    cfg = (registry.reduced_config(args.arch) if args.reduced
           else registry.get_config(args.arch))
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    check_train_arch(cfg)
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 1),
                       checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt,
                       microbatch=args.microbatch, fsdp=args.fsdp,
                       grad_compress=args.grad_compress, remat=True,
                       seed=args.seed)
    dev = resolve_device(args.device)
    data = SyntheticLM(vocab=args.data_vocab or cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch, seed=args.seed)
    trainer = Trainer(cfg, tcfg, global_batch=args.batch, seq_len=args.seq,
                      device=dev, data=data)
    print(f"[train] {cfg.name} reduced={args.reduced} device={dev} "
          f"start={trainer.start_step}")
    metrics = trainer.run(args.steps)
    print(f"[train] done: {metrics}")
    trainer.save(trainer.start_step)


if __name__ == "__main__":
    main()
