"""Quickstart on the PyTorch/CUDA port: partition a model across an
edge-cloud pipeline, serve a request, watch the network degrade, and
repartition live with Dynamic Switching, on the hand-written
flash-attention kernel.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # no card

The steps of ``examples/quickstart.py``, on ``repro_torch``'s modules.  On
the CPU the kernel's wrapper runs its plain PyTorch version.
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.network import NetworkModel
from repro_torch.core.partitioner import optimal_split
from repro_torch.core.profiler import profile_transformer
from repro_torch.core.stages import StageRunner
from repro_torch.core.switching import PipelineManager
from repro_torch.models import transformer as T


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # 1. a model (reduced qwen2.5 so it runs on a laptop CPU)
    cfg = get_config("qwen2.5-3b").reduced()
    params = T.init_model(cfg, device=args.device, seed=0)
    runner = StageRunner(cfg, params, attn_impl="kernel", device=args.device)
    gen = torch.Generator().manual_seed(1)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (1, 32),
                                      generator=gen).to(runner.device)}

    # 2. profile the layers and pick the Eq.-1-optimal split at 20 Mbps
    profile = profile_transformer(cfg, seq=32)
    fast = NetworkModel(bandwidth_mbps=20.0)
    split = optimal_split(profile, fast)
    print(f"optimal split @20 Mbps: after unit {split.split} "
          f"(T_e {split.t_edge*1e3:.2f} + T_t {split.t_transfer*1e3:.2f} "
          f"+ T_c {split.t_cloud*1e3:.2f} ms)")

    # 3. build the edge-cloud pipeline and serve
    mgr = PipelineManager(runner, split=split.split, net=fast,
                          sample_inputs=prompt)
    logits, timing = mgr.serve(prompt)
    print(f"served on {runner.device}: logits {tuple(logits.shape)}, "
          f"edge {timing.t_edge*1e3:.1f}ms / link {timing.t_transfer*1e3:.1f}"
          f"ms / cloud {timing.t_cloud*1e3:.1f}ms")

    # 4. the network drops to 5 Mbps -> the optimum moves -> switch live
    slow = NetworkModel(bandwidth_mbps=5.0)
    mgr.set_network(slow)
    new = optimal_split(profile, slow)
    print(f"optimal split @5 Mbps: after unit {new.split}")
    report = mgr.repartition("switch_b2", new.split)
    print(f"dynamic switching (B, case 2): downtime "
          f"{report.downtime*1e3:.1f} ms — service was never interrupted")

    logits2, _ = mgr.serve(prompt)
    assert torch.allclose(logits, logits2, atol=1e-4)
    print("same logits after repartition — the split is transparent ✓")
    mgr.close()


if __name__ == "__main__":
    main()
