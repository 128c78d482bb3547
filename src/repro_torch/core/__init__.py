"""repro_torch.core — the paper's contribution: minibatch-prox distributed
stochastic optimization (MP-DSVRG / MP-DANE), ported from `repro.core`.
The baselines it is analyzed against are not ported yet."""
from repro_torch.core import losses, prox, solvers, theory  # noqa: F401
from repro_torch.core.accounting import Ledger  # noqa: F401
from repro_torch.core.minibatch_prox import run_minibatch_prox  # noqa: F401
from repro_torch.core.mp_dane import run_mp_dane  # noqa: F401
from repro_torch.core.mp_dsvrg import run_mp_dsvrg  # noqa: F401
