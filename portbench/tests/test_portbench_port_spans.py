"""The port's spans in a traced window, on the card: the profiler ranges
they open add no record to the device's rows, which the per-layer metrics
read, and they name what the host was doing while the device stood idle.

    python3 -m pytest portbench/tests -m card -k port_spans
"""

import pytest

from portbench.tests.test_portbench_harness import CELLS, TINY

#: the prefixes of the port's span names
PORT_SPANS = ("phase.", "kernel_shap.", "compile.")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_ports_spans_add_no_device_record_and_name_idle_gaps(cell, cuda_card, monkeypatch):
    from portbench import harness, trace

    seen = {}
    reduce = trace.reduce

    def keeping(prof, calls):
        seen["ops"] = trace.ops_of(prof)
        return reduce(prof, calls)

    monkeypatch.setattr(trace, "reduce", keeping)
    line, _ = harness.run(cell, 123456789012, 2.0, True, device=str(cuda_card),
                          overrides=TINY[cell.split(".")[0]])
    assert line["correct"] is True
    device = {trace.short_name(o.name) for o in seen["ops"] if o.kind != "cpu"}
    assert device and not [n for n in device if n.startswith(PORT_SPANS)], device
    host = {o.name for o in seen["ops"] if o.kind == "cpu"}
    assert {"kernel_shap.explain", "kernel_shap.rank_features"} & host
    labels = [label.split(": ", 1)[1] for label, _ in line["breakdown"]["idle_gaps"]]
    assert any(label.startswith(PORT_SPANS) for label in labels), labels
