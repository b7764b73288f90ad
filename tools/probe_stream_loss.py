"""Whether the reference's synthetic token stream can lower a model's
loss in a few steps at a full-size vocabulary: both packages' ``train``
on reduced qwen2.5-3b widths (2 layers, d_model 256) with the published
151936-token vocabulary, on the CPU, and the port's step on the stream's
first batch repeated.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/probe_stream_loss.py \
        [--steps 20] [--seq 512] [--lr 3e-4]

Each of the stream's batches is an arithmetic progression from a fresh
random start, so at this vocabulary a step meets tokens it has not seen;
the repeated batch shows what a step does to a batch it has seen.
Prints each package's losses and the means of the first and last five.
Imports JAX (the reference) beside the port, as the CPU tests do.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    args = ap.parse_args()
    import torch

    from repro.configs import get_config as j_config
    from repro.training import train as j_train
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.training import make_train_step, train

    torch.set_num_threads(4)
    kw = dict(steps=args.steps, batch=1, seq=args.seq, lr=args.lr,
              log_every=0, remat=True, log_fn=lambda s: None)
    runs = {}
    for name, cfg_of, run in (("reference", j_config, j_train),
                              ("port", get_config, train)):
        cfg = dataclasses.replace(cfg_of("qwen2.5-3b").reduced(),
                                  vocab_size=151936)
        extra = {} if name == "reference" else {"device": "cpu"}
        runs[name] = run(cfg, **kw, **extra)["loss"]
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              vocab_size=151936)
    params = init_model(cfg, device="cpu", seed=0)
    step, init_opt = make_train_step(cfg, optimizer=adamw(
        schedule=cosine_schedule(args.lr, max(args.steps // 20, 1),
                                 args.steps)))
    opt = init_opt(params)
    batch = {k: torch.from_numpy(v) for k, v in
             next(iter(SyntheticTokens(cfg, 1, args.seq))).items()}
    repeated = []
    for _ in range(5):
        params, opt, m = step(params, opt, batch)
        repeated.append(m["loss"].item())
    runs["port, first batch repeated"] = repeated
    for name, losses in runs.items():
        print(f"{name}: losses {[round(x, 4) for x in losses]}; first five "
              f"{statistics.mean(losses[:5]):.4f}, last five "
              f"{statistics.mean(losses[-5:]):.4f}")


if __name__ == "__main__":
    main()
