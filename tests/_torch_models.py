"""Reduced models shared by the port's engine tests: the JAX package's
params for a reduced config at PRNGKey(0) and their conversion to the
port's layout, built once per test process (a worker runs several of the
files that use them)."""
import functools

import jax

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert


@functools.lru_cache(maxsize=None)
def reduced_models(arch="smollm-135m"):
    """(JAX config, JAX params, port config, port params) of arch's
    reduced config."""
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.from_jax(jax.device_get(jparams), tcfg)
    return jcfg, jparams, tcfg, tparams
