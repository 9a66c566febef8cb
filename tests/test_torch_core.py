"""The port's copies of the pure-Python planning stack (graph builders,
dispatcher, LOMA, targets, memory planner) decide exactly what the
reference decides."""

import pytest

import repro.backend
import repro.cnn
import repro_torch.backend
import repro_torch.cnn
from _torch_port import CELLS, NETS, node_rows, port_graph, port_mapped, ref_graph, ref_mapped, segment_rows


@pytest.mark.parametrize("net", NETS)
def test_graph_builders_match_reference(net):
    ref, port = ref_graph(net), port_graph(net)
    assert port.name == ref.name
    assert node_rows(port) == node_rows(ref)
    assert dict(port.inputs) == dict(ref.inputs)
    assert tuple(port.outputs) == tuple(ref.outputs)


@pytest.mark.parametrize("depthwise", [False, True])
def test_conv_block_builder_matches_reference(depthwise):
    kw = dict(IX=16, IY=12, C=8, K=16, stride=2, depthwise=depthwise)
    assert node_rows(repro_torch.cnn.conv_block_graph(**kw)) == node_rows(repro.cnn.conv_block_graph(**kw))


@pytest.mark.parametrize("net,tgt", CELLS)
def test_dispatch_matches_reference(net, tgt):
    ref, port = ref_mapped(net, tgt), port_mapped(net, tgt)
    assert port.target.name == ref.target.name
    assert segment_rows(port) == segment_rows(ref)
    assert port.total_cycles() == ref.total_cycles()
    assert port.cycles_by_module() == ref.cycles_by_module()


@pytest.mark.parametrize("net,tgt", CELLS)
def test_memory_plan_matches_reference(net, tgt):
    ref = repro.backend.plan_memory(ref_mapped(net, tgt)).to_dict()
    port = repro_torch.backend.plan_memory(port_mapped(net, tgt)).to_dict()
    assert port == ref


def test_analysis_matches_reference():
    for net in NETS:
        assert repro_torch.cnn.network_memory(port_graph(net)) == repro.cnn.network_memory(ref_graph(net))
