"""The traced run's spans: marker launches around labelled stretches of
host code, paired in the trace by the labels the hook kept in launch
order; a module's backward bracketed from its output's node to the node
that hands the gradient to its input."""

import pytest
import torch

from benchlib import cell, report
from benchlib.kineto import DeviceEvent


def _ev(name, launch, tid=1):
    return DeviceEvent(name=name, cat="kernel", start_ps=launch + 5,
                       end_ps=launch + 15, stream=7, launch_ps=launch,
                       launch_tid=tid)


def test_spans_pair_by_label_and_thread():
    marks = [_ev("spin_kernel", t, tid) for t, tid in
             ((10, 1), (30, 1), (40, 2), (60, 2), (70, 1), (90, 1))]
    labels = [["bn", "begin"], ["bn", "end"], ["bn", "begin"],
              ["bn", "end"], ["optimizer", "begin"], ["optimizer", "end"]]
    events = [_ev("fwd", 20), _ev("gap", 35), _ev("bwd", 50, tid=2),
              _ev("other-thread", 55, tid=1), _ev("sgd", 80)]
    found = report.spans(events, marks, labels)
    assert [e.name for e in found["bn"]] == ["fwd", "bwd"]
    assert [e.name for e in found["optimizer"]] == ["sgd"]


@pytest.mark.parametrize("labels", [
    [["bn", "begin"], ["bn", "end"]],                      # one too few
    [["bn", "end"], ["bn", "begin"], ["bn", "end"]],       # ends first
    [["bn", "begin"], ["bn", "begin"], ["bn", "end"]]],    # never closes
    ids=["count", "order", "open"])
def test_spans_that_do_not_pair_read_nothing(labels):
    marks = [_ev("spin_kernel", t) for t in (10, 20, 30)]
    assert report.spans([_ev("k", 15)], marks, labels) is None


@pytest.mark.parametrize("cross_rank", [False, True],
                         ids=["one_device", "cross_rank"])
def test_module_backward_is_bracketed(monkeypatch, cross_rank):
    """On the port's ConvBN (CPU, the marker launch replaced by nothing):
    the BatchNorm's forward and backward each sit between a begin and an
    end, and the conv's backward runs after the end."""
    from distributed_tensorflow_framework_torch.models import layers
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    block = layers.ConvBN(3, 8, (3, 3), dtype=torch.bfloat16)
    block.reset_parameters(torch.Generator().manual_seed(0))
    block.bn.cross_rank = cross_rank
    spans = cell.Spans()
    spans.bracket_module(block.bn, "batchnorm")
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    y = block(x)
    nodes, todo = [], [y.grad_fn]
    while todo:
        n = todo.pop()
        nodes.append(n)
        todo += [m for m, _ in n.next_functions if m is not None]
    conv = next(n for n in nodes if "Convolution" in type(n).__name__)
    conv.register_prehook(
        lambda grads: spans.marks.append(["conv", "backward"]))
    y.float().sum().backward()
    assert spans.marks == [["batchnorm", "begin"], ["batchnorm", "end"],
                           ["batchnorm", "begin"], ["batchnorm", "end"],
                           ["conv", "backward"]]
    assert x.grad is not None
