"""outer_copy_roofline: the outer vector's length against the port's
Diloco, a profile at exactly the least times, and a run without
profiles."""

import pytest
import torch

from portbench import flops, spec
from portbench.tests.conftest import TINY, tiny_cell

H100 = "NVIDIA H100 80GB HBM3"


def _reader():
    return spec.metric_reader("outer_copy_roofline")


@pytest.mark.parametrize("model_type", ["gpt2", "mistral"])
def test_count_is_the_port_outer_vector(model_type):
    from pccl_tpu_torch.parallel import train
    from pccl_tpu_torch.parallel.diloco import Diloco

    from portbench import port

    cfg = port.model_config(TINY[model_type], 32)
    params = train.family(cfg).init_params(torch.Generator().manual_seed(0), cfg)
    assert _reader().outer_count(TINY[model_type], 32) == Diloco(None, params).count


def _ctx(profiles, model_type="gpt2"):
    cell = tiny_cell(model_type)
    return {"cell": cell, "flops": flops, "device_name": H100,
            "records": [{"outer": [{"profile": p} for p in profiles]}]}


@pytest.mark.parametrize("model_type", ["gpt2", "mistral"])
def test_least_times_read_100(model_type):
    reader = _reader()
    cell = tiny_cell(model_type)
    n = reader.outer_count(cell.config, cell.traffic["block"])
    _, hbm = flops.peaks(H100)
    least = {k: n * (h / hbm + lk / reader.link(H100))
             for k, (h, lk) in reader.PHASE_BYTES.items()}
    # the ring and the stage copy have no least time and are not counted
    profile = dict(least, stage_copy=1.0, ring_reduce=2.0,
                   total=sum(least.values()) + 3.0)
    assert reader.read(_ctx([profile, dict(profile)], model_type)) == pytest.approx(100.0)
    slower = {k: 2 * v for k, v in least.items()}
    assert reader.read(_ctx([slower], model_type)) == pytest.approx(50.0)


def test_no_profiles_read_none():
    reader = _reader()
    assert reader.read(_ctx([])) is None
    assert reader.read(_ctx([None])) is None
    assert reader.read({"records": [{}]}) is None


def test_unlisted_card_raises():
    with pytest.raises(KeyError):
        _reader().link("cpu")
