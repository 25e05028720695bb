"""The port's FLOP accounting (``workloads/flops.py``) against the
reference's analytic counts, exactly, for the default and small configs;
the port's own peak table; and the sweep total on a ``Result``."""

import pytest
import torch

from hpbandster_tpu_torch.workloads import flops
from hpbandster_tpu_torch.workloads.cnn import CNNConfig
from hpbandster_tpu_torch.workloads.mlp import MLPConfig
from hpbandster_tpu_torch.workloads.resnet import ResNetConfig
from hpbandster_tpu_torch.workloads.teacher import TeacherConfig
from hpbandster_tpu_torch.workloads.transformer import TransformerConfig
from tests.test_torch_harness import ref, ref_wl  # noqa: F401

SMALL = {
    "MLPConfig": dict(d_in=8, width=16, n_classes=4, n_train=64, n_val=32, batch_size=16),
    "TeacherConfig": dict(n_train=256, n_val=128, student_width=16, batch_size=64),
    "CNNConfig": dict(image_size=8, width=8, n_classes=4, n_train=64, n_val=32, batch_size=32),
    "ResNetConfig": dict(image_size=8, width=8, groups=2, n_classes=4, n_train=64, n_val=32,
                         batch_size=32),
    "TransformerConfig": dict(vocab=8, prefix_len=5, d_model=16, n_heads=2, n_layers=2,
                              d_ff=64, n_train=64, n_val=32, batch_size=16),
}
#: count function -> (port config class, reference module holding its class)
COUNTS = {
    "mlp_step_flops": (MLPConfig, "mlp"),
    "teacher_step_flops": (TeacherConfig, "teacher"),
    "teacher_epoch_flops": (TeacherConfig, "teacher"),
    "cnn_step_flops": (CNNConfig, "cnn"),
    "resnet_step_flops": (ResNetConfig, "resnet"),
    "transformer_step_flops": (TransformerConfig, "transformer"),
}
FORWARD = {
    "mlp_forward_flops": (MLPConfig, "mlp"),
    "cnn_forward_flops": (CNNConfig, "cnn"),
    "resnet_forward_flops": (ResNetConfig, "resnet"),
    "transformer_forward_flops": (TransformerConfig, "transformer"),
}


@pytest.mark.parametrize("size", ["default", "small"])
@pytest.mark.parametrize("name", sorted(COUNTS) + sorted(FORWARD))
def test_counts_equal_the_reference(ref_wl, name, size):
    cls, module = {**COUNTS, **FORWARD}[name]
    kw = {} if size == "default" else SMALL[cls.__name__]
    ref_cls = getattr(getattr(ref_wl, module), cls.__name__)
    port_fn, ref_fn = getattr(flops, name), getattr(ref_wl.flops, name)
    if name in FORWARD:
        for batch in (1, 7, 128):
            assert port_fn(cls(**kw), batch) == ref_fn(ref_cls(**kw), batch)
    else:
        assert port_fn(cls(**kw)) == ref_fn(ref_cls(**kw))
    assert cls(**kw)._fields == ref_cls(**kw)._fields and tuple(cls(**kw)) == tuple(ref_cls(**kw))


def test_peak_table_is_the_cards():
    assert flops.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert flops.peak_bf16_flops("Some Other Card") is None
    assert flops.peak_bf16_flops("TPU v5 lite") is None
    assert flops.peak_bf16_flops(torch.device("cpu")) is None


class _Run:
    def __init__(self, budget, loss):
        self.budget, self.loss = budget, loss


class _Result:
    def __init__(self, runs):
        self.runs = runs

    def get_all_runs(self):
        return self.runs


def test_sweep_training_flops_counts_budgets(ref_wl):
    res = _Result([_Run(3.0, 0.5), _Run(9.0, None), _Run(9.0, 0.2), _Run(27.0, 0.1)])
    for kw in ({}, dict(include_failed=True), dict(steps_per_budget_unit=4.0)):
        assert flops.sweep_training_flops(res, 10.0, **kw) == \
            ref_wl.flops.sweep_training_flops(res, 10.0, **kw)
    assert flops.sweep_training_flops(res, 2.0, include_failed=True) == 2.0 * 48.0
