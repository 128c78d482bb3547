"""repro_torch.core — the paper's contribution: minibatch-prox distributed
stochastic optimization (MP-DSVRG / MP-DANE) and the baselines it is
analyzed against, ported from `repro.core`."""
from repro_torch.core import losses, prox, solvers, theory  # noqa: F401
from repro_torch.core.accounting import Ledger  # noqa: F401
from repro_torch.core.baselines import (  # noqa: F401
    BaselineResult, run_acc_minibatch_sgd, run_dsvrg_erm, run_emso,
    run_minibatch_sgd, run_single_sgd)
from repro_torch.core.minibatch_prox import run_minibatch_prox  # noqa: F401
from repro_torch.core.mp_dane import run_mp_dane  # noqa: F401
from repro_torch.core.mp_dsvrg import run_mp_dsvrg  # noqa: F401
