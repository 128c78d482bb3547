"""Hand-written Hopper kernels of the port and their plain twins.

  paged_attention    csrc/paged_attention.cu   decode, every step and layer
  paged_prefill      csrc/paged_prefill.cu     admission, chunks, verify
  flash_attention    csrc/flash_attention.cu   dense lm.forward / prefill
  svrg_update        csrc/svrg_update.cu       every step of MP-DSVRG's pass
  rglru_scan         csrc/rglru_scan.cu        every RG-LRU layer, T = S or 1
  rwkv6_scan         csrc/rwkv6_scan.cu        every RWKV6 layer, T = S or 1

Each wrapper takes its plain twin (`ref.py`) for a CPU tensor and launches
its kernel (built by `build.py` at first use) for a CUDA tensor.
"""
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_prefill import paged_prefill_attention
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.svrg_update import svrg_update

WRAPPERS = {"paged_attention": paged_attention,
            "paged_prefill": paged_prefill_attention,
            "flash_attention": flash_attention,
            "svrg_update": svrg_update,
            "rglru_scan": rglru_scan,
            "rwkv6_scan": rwkv6_scan}


def launch_counts():
    """{kernel name: launches so far} for every kernel wrapper."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
