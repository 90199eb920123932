"""repro_torch.policy: the pluggable policy layer (PyTorch port of
``repro/policy``).

The three decisions that govern how the optimizer spends exact-oracle
calls -- which blocks to visit (*sampling*), which cached planes to evict
(*eviction*), and when to trust the cache over the oracle (*oracle*) --
are three small protocols and a :class:`PolicyBundle` an engine holds:
policies are frozen dataclasses of parameters whose methods run on the
cache's device, so a bundle adds no dispatch and no host sync.

Shipped policies::

    sampling   uniform    the solver's uniform permutation (BCFW baseline)
               gap-topk   gap-proportional gumbel-top-k (arXiv:1605.09346)
    eviction   ttl-lru    paper Sec-3.4 TTL (+ LRU overwrite on insert)
               gap-ttl    shorter TTL for gap-converged blocks
    oracle     slope      paper Sec-3.4 geometric slope rule

:data:`DEFAULT_POLICIES` reproduces the pre-policy engines bit for bit;
:data:`GAP_POLICIES` is the ``mpbcfw-gap`` bundle.  Register new
policies with :func:`register_policy` and name them in
``RunConfig.policies``.
"""
from .base import (DEFAULT_POLICIES, GAP_POLICIES,  # noqa: F401
                   EvictionPolicy, OraclePolicy, PolicyBundle,
                   SamplingPolicy, make_bundle, policy_kind, policy_names,
                   register_policy)
from .eviction import GapTTL, TTLEviction  # noqa: F401
from .oracle import SlopeOracle  # noqa: F401
from .sampling import GapSampling, UniformSampling  # noqa: F401

__all__ = [
    "SamplingPolicy", "EvictionPolicy", "OraclePolicy", "PolicyBundle",
    "register_policy", "policy_kind", "policy_names", "make_bundle",
    "DEFAULT_POLICIES", "GAP_POLICIES",
    "UniformSampling", "GapSampling", "TTLEviction", "GapTTL",
    "SlopeOracle",
]
