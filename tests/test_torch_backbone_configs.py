"""Three configs of the ResNet-family backbones in the port against the
JAX package on the CPU, fp32, each shrunk as test_torch_backbones.py's
``tiny_cfg`` shrinks it (``faster_rcnn_r2_101_fpn_2x``,
``faster_rcnn_s50_fpn_syncbn-backbone+head_mstrain-range_1x``,
``mask_rcnn_hrnetv2p_w32_1x``):

- ``simple_test`` on the same weights and batch statistics;
- ``forward_train`` with the same sampler keys and proposals: losses and
  every gradient (the CPU is the one place the res2net config trains
  against the JAX package; chip_smoke.py trains resnest and hrnet on the
  card);
- the weights through ``state_dict_from_jax`` and back through the JAX
  converter bit for bit.

The checks and their tolerances are test_torch_backbones.py's; the JAX
package's tracing and XLA compiles of each detector (about 15 s a config)
set this file's time, which is why it stands apart from that one (which
runs the fourth, regnet).
"""
import pytest

from tests.test_torch_backbones import (CONFIGS, check_forward_train,
                                        check_round_trip, check_simple_test,
                                        detector_case, tiny_cfg)
from tests.torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(scope='module', params=[c for c in CONFIGS if c != 'regnet'])
def config_case(request):
    return detector_case(tiny_cfg(request.param))


def test_config_simple_test_matches_jax(config_case):
    check_simple_test(config_case)
    kind = type(config_case['port'].backbone).__name__
    assert kind == config_case['cfg']['backbone']['type']
    if kind == 'HRNet':
        assert type(config_case['port'].neck).__name__ == 'HRFPN'


def test_config_forward_train_matches_jax(config_case):
    check_forward_train(config_case)


def test_config_weights_round_trip_bit_exact(config_case):
    check_round_trip(config_case)
