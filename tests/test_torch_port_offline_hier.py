"""Offline conversion of the PyTorch port's vqvae2 against the JAX package
on the CPU (the hierarchy of ``tests/torch_port_fixtures/
hier_golden.msgpack``): ``decode`` over trials with one to three targets
per line (per-level speaker columns), the encode-once ``sweep``,
compressed outputs, an unknown target, against the JAX ``Converter`` and
the committed ``offline_golden.npz``. The helpers, and the fixture's
generator, are in ``tests/test_torch_port_offline_decode.py``.
"""

import pytest
import torch

from tests.test_torch_port_offline_decode import (check_committed,
                                                  check_compressed,
                                                  check_port_matches,
                                                  check_unknown_target,
                                                  jax_reference)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hier(tmp_path_factory):
    return jax_reference("hier", tmp_path_factory.mktemp("hier"))


def test_hier_offline_fixture_matches_jax(hier):
    check_committed("hier", hier)


def test_hier_decode_and_sweep_match_jax(hier, tmp_path):
    check_port_matches("hier", hier, tmp_path)


def test_hier_compressed_outputs_within_a_step(hier, tmp_path):
    check_compressed("hier", hier, tmp_path)


def test_hier_unknown_target_raises_jax_error(hier, tmp_path):
    check_unknown_target("hier", hier, tmp_path)
