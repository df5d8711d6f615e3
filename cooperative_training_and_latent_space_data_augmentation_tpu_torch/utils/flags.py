"""The registry of the port's knobs: every ``cli.train`` flag and
constructor keyword that selects a path.

Counterpart of the JAX package's ``utils/flags.py``, whose registry lists
trace-time environment variables with the TPU measurements that set their
defaults.  The port reads no environment variable that selects a path (its
one, the kernels' build directory in ``kernels.py``, moves files only), so
its registry lists the command line's flags and the keywords behind them.
Each :class:`Flag` gives the knob's default, what the default
configuration runs, where the knob is read, and its ``evidence``: the
entry of ``PERF.md`` section 5 that holds the card's measurement, with
the card's name and power limit, or "not measured on the card".  The
figures stay in ``PERF.md``.  No TPU figure is evidence here.  Defaults
stay as the JAX package ships them until the port's benchmark decides.

:func:`lookup` and :func:`markdown_table` (the README's table, held to it
by ``tests/test_torch_port_flags.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

CARD = "H100 80GB HBM3, 700.00 W"


@dataclass(frozen=True)
class Flag:
    name: str               # the knob
    default: Any            # its default (argparse's and the keyword's)
    kind: str               # 'bool' | 'str' | 'int'
    ships: str              # what the default configuration runs
    evidence: str           # PERF.md's entry of the card's figure, or "not measured on the card"
    where: str              # module:symbol reading it
    cli: Optional[str]      # the cli.train argparse dest that sets it, if any
    keyword: Optional[str]  # "module:Callable.parameter" taking it, if any


REGISTRY: Tuple[Flag, ...] = (
    Flag("bf16", False, "bool",
         "float32 convs (the JAX entry's default; the smoke and the seed band "
         "train with --bf16)",
         "not measured on the card as an A/B of one step",
         "cli/train.py:build_trainer (compute_dtype=torch.bfloat16)", "bf16", None),
    Flag("conv_s2", False, "bool",
         "the encoders' stride-2 downsamples on cuDNN (kernel K4 off)",
         f"PERF.md section 5, eager train step and the arms phase ({CARD})",
         "ops/conv_chw.py:Conv.uses_k4", "conv_s2",
         "train.cooperative:CooperativeTrainer.conv_s2"),
    Flag("conv_nl", False, "bool",
         "the residual stages' 64..128-channel 3x3 convs on cuDNN (kernel K5 off)",
         f"PERF.md section 5, eager train step and the arms phase ({CARD})",
         "ops/conv_chw.py:Conv.uses_k5", "conv_nl",
         "train.cooperative:CooperativeTrainer.conv_nl"),
    Flag("remat", False, "bool",
         "no rematerialisation of the module forwards",
         "not measured on the card",
         "train/cooperative.py:CooperativeTrainer._module_call", "remat",
         "train.cooperative:CooperativeTrainer.remat"),
    Flag("saliency_bn_update", False, "bool",
         "saliency forwards leave the BN running statistics alone",
         "not measured on the card",
         "train/cooperative.py:CooperativeTrainer.hard_example_generation",
         "saliency_bn_update", "train.cooperative:CooperativeTrainer.saliency_bn_update"),
    Flag("fused_stn", False, "bool",
         "sequential STN passes",
         f"PERF.md section 5, the arms phase ({CARD}); off, as in the JAX package, until "
         f"the benchmark decides",
         "train/cooperative.py:CooperativeTrainer._losses_fused_stn", "fused_stn",
         "train.cooperative:CooperativeTrainer.fused_stn"),
    Flag("fused_ftn", False, "bool",
         "sequential standard and hard FTN passes",
         f"PERF.md section 5, the arms phase ({CARD})",
         "train/cooperative.py:CooperativeTrainer._losses_fused_ftn", "fused_ftn",
         "train.cooperative:CooperativeTrainer.fused_ftn"),
    Flag("warp", "composed", "str",
         "one composed order-3 warp of image and one-hot label (one gather)",
         f"PERF.md section 5, the arms phase ({CARD})",
         "ops/augment.py:make_batch_train_pipeline", "warp",
         "train.driver:train_network.warp"),
    Flag("fused_epoch", False, "bool",
         "the streaming epoch: eager steps, one host round trip a batch",
         f"PERF.md section 5, graphed step and fused epoch ({CARD})",
         "train/driver.py:train_network", "fused_epoch",
         "train.driver:train_network.fused_epoch"),
    Flag("multi_epoch", 0, "int",
         "no K-epoch window (with --fused_epoch: one graphed epoch a dispatch)",
         f"PERF.md section 5, graphed step and fused epoch ({CARD})",
         "train/driver.py:train_network", "multi_epoch",
         "train.driver:train_network.multi_epoch"),
    Flag("pipeline_epoch", False, "bool",
         "each fused epoch read back before the next is dispatched",
         f"PERF.md section 5, graphed step and fused epoch ({CARD})",
         "train/driver.py:train_network", "pipeline_epoch",
         "train.driver:train_network.pipeline_epoch"),
    Flag("n_devices", None, "int",
         "one process on one device",
         f"PERF.md section 5, data-parallel ranks (two gloo ranks sharing one card; one "
         f"NCCL rank's sharded fused epoch; {CARD}); NCCL across two cards not measured",
         "cli/train.py:n_ranks", "n_devices", None),
    Flag("capturable", False, "bool",
         "Adam's step on the host; no CUDA graph (set by --fused_epoch on the card)",
         f"PERF.md section 5, graphed step and fused epoch ({CARD})",
         "cli/train.py:build_trainer", "fused_epoch",
         "train.cooperative:CooperativeTrainer.capturable"),
)


def lookup(name: str) -> Flag:
    for f in REGISTRY:
        if f.name == name:
            return f
    raise KeyError(name)


def markdown_table() -> str:
    """The registry as the README's table."""
    lines = ["| knob | default | ships | evidence (the card's) | read at |",
             "|---|---|---|---|---|"]
    for f in REGISTRY:
        lines.append(f"| `{f.name}` | `{f.default}` | {f.ships} | {f.evidence} | "
                     f"`{f.where}` |")
    return "\n".join(lines)
