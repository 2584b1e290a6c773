"""The per-layer metrics that read the program's own spans of the host
work around the kernels: the monolithic write's set-up, copies and MoP
selection, and the monolithic read's unpack, Huffman decode and
reconstruction, reported by the traced tiny cells on the CPU."""
import pytest
import tiny

WRITE = ("host_prep_ms.write", "mop_select_ms.write")
READ = ("decode_codec_ms.read", "huffman_ms.read", "reconstruct_ms.read")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell, names", [("mono-tiny.write", WRITE),
                                         ("mono-tiny.read", READ)])
def test_traced_cell_reports_the_host_spans(root, cell, names):
    result, _ = tiny.run(root, cell, trace=True)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    for name in names:
        assert metrics[name]["unit"] == "ms"
        assert metrics[name]["value"] > 0, name
    # on the CPU the profiler sees no device work: the breakdown has no
    # device operation and the device-trace readers say nothing
    assert result["breakdown"]["device_ops"] == []
    assert not any(n.startswith("device_idle_pct") for n in metrics)


@pytest.mark.parametrize("cell, names", [("mono-tiny.write", WRITE),
                                         ("mono-tiny.read", READ),
                                         ("tiled-tiny.write", WRITE + READ)])
def test_untraced_cell_reports_no_span_metric(root, cell, names):
    result, _ = tiny.run(root, cell)
    assert not set(names) & set(result["metrics"])
