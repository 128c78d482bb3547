"""Hand-written Hopper kernels of the port and their plain twins.

  paged_attention    csrc/paged_attention.cu   decode, every step and layer
  paged_prefill      csrc/paged_prefill.cu     admission, chunks, verify
  flash_attention    csrc/flash_attention.cu   dense lm.forward / prefill
  svrg_update        csrc/svrg_update.cu       every step of MP-DSVRG's pass

Each wrapper takes its plain twin (`ref.py`) for a CPU tensor and launches
its kernel (built by `build.py` at first use) for a CUDA tensor.
"""
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_prefill import paged_prefill_attention
from repro_torch.kernels.svrg_update import svrg_update

WRAPPERS = {"paged_attention": paged_attention,
            "paged_prefill": paged_prefill_attention,
            "flash_attention": flash_attention,
            "svrg_update": svrg_update}


def launch_counts():
    """{kernel name: launches so far} for every kernel wrapper."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
