"""The tiny configuration and flags that tests/test_torch_bench.py and its
rank worker run the port's measuring tools at (not a pytest module)."""
from mipnerf360_torch.config import Config, DataConfig, ModelConfig
from mipnerf360_torch.tools import bench

TINY_MODEL = ModelConfig(num_samples=8, hidden_proposal=16, hidden_nerf=16,
                         nerf_depth=2, compute_dtype="float32")
TINY = Config(model=TINY_MODEL,
              data=DataConfig(dataset="synthetic", synthetic_resolution=8,
                              synthetic_views=2))
# Global batch, steps per window, warm-ups (at least 2 run), windows.
B, K, WARMUP, REPEATS = 32, 2, 2, 2


def bench_args(*extra):
    return bench.parse_args(["--device", "cpu", "--batch", str(B), "--steps",
                             str(K), "--warmup", str(WARMUP), "--repeats",
                             str(REPEATS), *extra])
