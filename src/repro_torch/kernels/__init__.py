"""Hand-written Hopper kernels of the port and their plain twins.

  paged_attention    csrc/paged_attention.cu   decode, every step and layer
  paged_prefill      csrc/paged_prefill.cu     admission, chunks, verify
  flash_attention    csrc/flash_attention.cu   dense lm.forward / prefill
  flash_attention_bwd  csrc/flash_attention_bwd.cu  its gradient (training)
  svrg_update        csrc/svrg_update.cu       every step of MP-DSVRG's pass
  rglru_scan         csrc/rglru_scan.cu        every RG-LRU layer, T = S or 1
  rwkv6_scan         csrc/rwkv6_scan.cu        every RWKV6 layer, T = S or 1

Each wrapper takes its plain twin (`ref.py`) for a CPU tensor and launches
its kernel (built by `build.py` at first use) for a CUDA tensor.
"""
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_prefill import paged_prefill_attention
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.svrg_update import svrg_update

WRAPPERS = {"paged_attention": paged_attention,
            "paged_prefill": paged_prefill_attention,
            "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "svrg_update": svrg_update,
            "rglru_scan": rglru_scan,
            "rwkv6_scan": rwkv6_scan}


def launch_counts():
    """{kernel name: launches so far} for every kernel wrapper."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


# counts of one arm of a kernel, kept beside its launches
ARM_COUNTS = {"paged_attention_quant": (paged_attention, "quant_launches"),
              "paged_prefill_quant": (paged_prefill_attention,
                                      "quant_launches"),
              "rwkv6_scan_states": (rwkv6_scan, "state_launches")}


def arm_launch_counts():
    """{arm name: launches of that arm so far}: the quantized-pool arms of
    the paged kernels and rwkv6_scan with per-step states."""
    return {name: getattr(fn, attr) for name, (fn, attr)
            in ARM_COUNTS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
    for fn, attr in ARM_COUNTS.values():
        setattr(fn, attr, 0)
