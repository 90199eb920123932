"""The port's shard engines at world size 1 against the JAX package's on
a 1-device mesh, on ``SMALL`` usps and horseseg (``SMALL`` ocr, and the
bit-for-bit twins on all three, are in ``tests/test_torch_shard.py``):
3-iteration traces with the same schedule and sync counts, objectives
within rtol 1e-4, collectives and bytes equal, one collective per pass.
``mpbcfw-gap`` runs with the port's noise function patched to
``jax.random.gumbel``, so both packages sample the same schedule.
"""
import pytest
import torch

from repro_torch.launch import mesh as tmesh

from test_torch_shard import AGAINST_JAX, against_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_data_mesh(device="cpu")


@pytest.mark.parametrize("name", ["usps", "horseseg"])
@pytest.mark.parametrize("algo,tau", AGAINST_JAX)
def test_world_size_one_matches_jax(name, algo, tau, mesh, monkeypatch):
    against_jax(name, algo, tau, mesh, monkeypatch)
