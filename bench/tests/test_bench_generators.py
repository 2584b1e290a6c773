"""The seeded generators: the same seed gives the same field, another
seed another, and successive chunks continue one simulation."""
import tiny  # noqa: F401  (puts the checkout on sys.path)
import pytest
import torch

from bench.generators import heated_plume, vortex_street

GENS = [(vortex_street, (5, 24, 40)), (heated_plume, (5, 30, 20))]


@pytest.mark.parametrize("gen,shape", GENS, ids=["vortex", "plume"])
def test_same_seed_same_field(gen, shape):
    a = gen.make(*shape, 0, 12345, "cpu")
    b = gen.make(*shape, 0, 12345, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].dtype == torch.float32 and a[0].shape == shape


@pytest.mark.parametrize("gen,shape", GENS, ids=["vortex", "plume"])
@pytest.mark.parametrize("other", [12346, 2 ** 31 + 7, 2 ** 40 + 1])
def test_other_seed_other_field(gen, shape, other):
    a = gen.make(*shape, 0, 12345, "cpu")
    b = gen.make(*shape, 0, other, "cpu")
    assert not torch.equal(a[0], b[0])


@pytest.mark.parametrize("gen,shape", GENS, ids=["vortex", "plume"])
def test_chunks_continue_one_simulation(gen, shape):
    T, H, W = shape
    whole = gen.make(2 * T, H, W, 0, 99, "cpu")
    second = gen.make(T, H, W, T, 99, "cpu")
    for w, s in zip(whole, second):
        torch.testing.assert_close(w[T:], s, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("gen,shape", GENS, ids=["vortex", "plume"])
def test_same_seed_same_field_on_the_card(gen, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = gen.make(*shape, 0, 2 ** 31 + 3, "cuda")
    b = gen.make(*shape, 0, 2 ** 31 + 3, "cuda")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
