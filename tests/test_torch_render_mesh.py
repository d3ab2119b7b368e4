"""The data-parallel ``render_image`` must match the one-rank render
(counterpart of tests/test_render_mesh.py): 4 gloo ranks on the CPU
(``_torch_ranks.py``) on ``default_render_mesh()``, every rank returning the
whole result."""
import numpy as np
import pytest

from _torch_ranks import run_ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("_torch_render_worker.py", 4,
                     tmp_path_factory.mktemp("render"))


def test_mesh_render_matches_single_device(ranks):
    for r in ranks:
        assert (int(r["mesh_data"]), int(r["mesh_model"])) == (4, 1)
        for k in ("rgb", "distance", "acc"):
            np.testing.assert_allclose(r[f"mesh_{k}"], r[f"one_rank_{k}"],
                                       atol=1e-6, rtol=1e-6, err_msg=k)
            np.testing.assert_array_equal(r[f"mesh_{k}"],
                                          ranks[0][f"mesh_{k}"])


def test_mesh_render_rounds_chunk_to_axis(ranks):
    # chunk=50 is not divisible by 4 -> rounded up to 52; the output keeps
    # the un-padded ray count
    for r in ranks:
        assert r["mesh_50_rgb"].shape == (200, 3)
        assert r["mesh_50_distance"].shape == r["mesh_50_acc"].shape == (200,)
        np.testing.assert_allclose(r["mesh_50_rgb"], r["one_rank_rgb"],
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
def test_sample_shards_render_stays_on_the_card(tmp_path):
    """``render_image(sample_shards=2, device="cuda")`` under a gloo group
    renders on the card through K1, not on the mesh's CPU; against the
    one-rank render on the CPU at the whole path's float32 tolerance of
    tests/test_torch_cuda.py (rtol/atol 1e-4)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for r in run_ranks("_torch_render_worker.py", 2, tmp_path, "cuda"):
        assert int(r["on_card"]) == 1
        assert int(r["k1_launches"]) > 0
        np.testing.assert_allclose(r["card_rgb"], r["one_rank_rgb"],
                                   atol=1e-4, rtol=1e-4)
