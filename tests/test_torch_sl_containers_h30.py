"""The checks of tests/test_torch_sl_containers.py at a plane height
that is no multiple of the Pallas kernel's 8-row tile (H = 30: the
"pallas" tag runs the f64 "xla" path, as in the JAX package), and the
"xla" golden container (CPU).
"""
import pytest

pytest.importorskip("torch")

import test_torch_sl_containers as C

SHAPE = (6, 30, 40)


@pytest.mark.parametrize("codec", ["host", "device"])
@pytest.mark.parametrize("predictor", ["sl", "mop"])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_reference_container_decodes_and_bytes_equal(backend, predictor,
                                                     codec):
    C.check_container(SHAPE, backend, predictor, codec)


def test_fields_are_non_vacuous():
    C.check_non_vacuous(SHAPE)


def test_golden_container_is_the_references():
    assert C.GOLDEN["xla"] == SHAPE
    C.check_golden_is_the_references("xla")


def test_golden_container_decodes_bitwise():
    C.check_golden_decodes_bitwise("xla")
