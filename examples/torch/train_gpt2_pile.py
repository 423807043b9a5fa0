"""End-to-end training driver on the PyTorch port (paper setup, scaled):
GPT-2-family model on a Pile-like token stream, Adapprox optimizer,
fault-tolerant loop with atomic async checkpointing and restart-resume
(the port's counterpart of ``examples/train_gpt2_pile.py``).

The smoke config by default; ``--full`` is GPT-2 117M at full width
(12 layers, d 768, batch 16 x 256), on the launcher's default mixed
groups (the count-min sketch on ``embed`` and ``pos_embed``, Adapprox on
the block matrices, dense Adam on the rest):

    PYTHONPATH=src python examples/torch/train_gpt2_pile.py [--full]
    PYTHONPATH=src python examples/torch/train_gpt2_pile.py --device cpu

It runs on the GPU; ``--device cpu`` is the only way onto the CPU, and
without a GPU and without it the launcher raises.  ``--ckpt-dir`` puts
the checkpoints there instead of a new temporary directory, and
``--log-every N`` logs (and keeps in the history) every N-th step
instead of the launcher's every 20th.
"""
import argparse
import logging
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> tuple:
    """Train, then run the same command again, which restores at the last
    checkpoint and finishes without a step; returns both runs'
    ``(state, history)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="full GPT-2 117M config (needs a GPU)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temp dir)")
    ap.add_argument("--log-every", default=None,
                    help="the launcher's --log-every (default: its own)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="gpt2_adapprox_")
    argv = ["--arch", "gpt2-117m", "--steps", str(args.steps),
            "--optimizer", "adapprox", "--ckpt-dir", ckpt_dir,
            "--ckpt-every", "100", "--batch", "16", "--seq", "256",
            "--device", args.device]
    if args.log_every is not None:
        argv += ["--log-every", args.log_every]
    if not args.full:
        argv.append("--smoke")
    print(f"checkpoints -> {ckpt_dir}")
    first = train_main(argv)
    print("re-running to demonstrate restart-resume from the checkpoint:")
    # restores at the last checkpoint and finishes instantly
    second = train_main(argv)
    return first, second


if __name__ == "__main__":
    main()
