"""The paper's own experiment (Figs. 2-3) on the PyTorch/CUDA port: profile
VGG-19 / MobileNetV2 layer by layer and show where the optimal split sits
as the bandwidth changes, then repartition a live MobileNetV2 pipeline
once with every strategy in the registry to see the downtime/memory space
a split move opens up.

    PYTHONPATH=src python examples/repartition_cnn_torch.py            # the card, 224 px
    PYTHONPATH=src python examples/repartition_cnn_torch.py --smoke --device cpu

The twin of ``examples/repartition_cnn.py`` on ``repro_torch``'s modules.
``--smoke`` profiles at 64 px (the published 224 otherwise).  On the card
each unit is timed there and priced twice: with the reference's default
specs (the edge 4x slower than the measuring device) and with the card as
the cloud and the edge spec as the edge ("h100 pricing",
``core/hardware.py``).
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import PAPER_ARCHS, get_config
from repro_torch.core.hardware import EDGE_SPEC, H100
from repro_torch.core.network import NetworkModel
from repro_torch.core.partitioner import optimal_split
from repro_torch.core.profiler import profile_cnn
from repro_torch.core.stages import CnnStageRunner
from repro_torch.core.strategies import benchmark_specs
from repro_torch.core.switching import PipelineManager


def split_analysis(device, hw, pricings):
    for arch in PAPER_ARCHS:
        cfg = dataclasses.replace(get_config(arch), input_hw=hw)
        runner = CnnStageRunner(cfg, generator=torch.Generator().manual_seed(0),
                                device=device)
        print(f"\n{arch}@{hw}px: {runner.num_units} partition units")
        for label, kw in pricings:
            profile = profile_cnn(cfg, runner.params, runner.units,
                                  runner.shapes, reps=2, **kw)
            best = {}
            for bw in (20.0, 5.0):
                best[bw] = optimal_split(profile, NetworkModel(bw))
                u = profile.units[best[bw].split]
                print(f"  {label}: @{bw:4.0f} Mbps optimal split after "
                      f"{u.name:10s} (boundary "
                      f"{u.boundary_bytes // 1024:6d} KB, total "
                      f"{best[bw].total * 1e3:9.1f} ms)")
            verdict = "MOVED" if best[20.0].split != best[5.0].split \
                else "did not move"
            print(f"  -> {label}: optimal split {verdict} when bandwidth "
                  f"dropped (paper Fig. {'2' if arch == 'vgg19' else '3'})")
        del runner


def strategy_space_demo(device, arch="mobilenetv2", hw=64):
    """One live repartition per registered strategy (downtime + memory)."""
    cfg = dataclasses.replace(get_config(arch), input_hw=hw)
    runner = CnnStageRunner(cfg, generator=torch.Generator().manual_seed(0),
                            device=device)
    profile = profile_cnn(cfg, runner.params, runner.units, runner.shapes,
                          reps=1)
    sample = {"image": torch.zeros((1, hw, hw, cfg.input_ch),
                                   device=runner.device)}
    fast = optimal_split(profile, NetworkModel(20.0)).split
    slow = optimal_split(profile, NetworkModel(5.0)).split
    if slow == fast:
        slow = fast + 1 if fast < runner.num_units - 2 else fast - 1
    print(f"\n{arch}@{hw}px live strategy space (split {fast} -> {slow}):")
    for spec in benchmark_specs():
        mgr = PipelineManager(runner, split=fast, net=NetworkModel(20.0),
                              sample_inputs=sample)
        mgr.get_strategy(spec).prepare(mgr.pool,
                                       candidate_splits=(slow, fast))
        mgr.set_network(NetworkModel(5.0))
        rep = mgr.repartition(spec, slow)
        mem = mgr.memory_report()
        mem_x = mem["total_bytes"] / max(mem["initial_bytes"], 1)
        print(f"  {spec:17s} downtime {rep.downtime*1e3:9.2f} ms  "
              f"mem {mem_x:4.1f}x  outage={int(rep.full_outage)}")
        mgr.close()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="profile at 64 px instead of the published 224")
    args = ap.parse_args()
    pricings = [("default specs", {})]
    if torch.device(args.device).type == "cuda":
        pricings.append(("h100 pricing", {"edge": EDGE_SPEC, "cloud": H100}))
    split_analysis(args.device, 64 if args.smoke else 224, pricings)
    strategy_space_demo(args.device)


if __name__ == "__main__":
    main()
