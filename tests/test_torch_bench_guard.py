"""The port's regression guard (``utils/benchguard.py``) and its own
thresholds file (``spartan_tpu_torch/utils/thresholds.json``), on the
CPU: each case of ``tests/test_bench_guard.py`` against the port's file,
with the grading of the same metrics and files equal to the JAX
package's ``check``. No measurement runs here; ``chip_smoke.py``'s
``[benchguard]`` phase grades a card run against the file."""

import json
import os

from spartan_tpu.utils import benchguard as bg_j
from spartan_tpu_torch.utils import benchguard

# the figures the file's bounds were set from: one chip_smoke.py run on
# the card the file names (PERF.md section 6)
MEASURED = {
    "dot_gflops": 50971.84,
    "kmeans_iters_per_sec": 1444.93,
    "pagerank_iters_per_sec": 2481.13,
    "logreg_iters_per_sec": 743.88,
    "ssvd_seconds": 0.0092,
    "naive_bayes_fit_ms": 2.3832,
    "kernel_ms:kmeans_assign_accumulate": 0.6745,
    "kernel_ms:windowed_segsum": 0.0771,
    "kernel_ms:segment_sum_block": 0.2744,
    "kernel_ms:partition_pack": 0.8703,
    "kernel_ms:shard_topk": 0.2547,
    "kernel_ms:bincount_block": 0.1014,
    "kernel_ms:conv_block": 2.2766,
    "kernel_ms:fixed_order_reduce": 0.3563,
}
RATES = ("dot_gflops", "kmeans_iters_per_sec", "pagerank_iters_per_sec",
         "logreg_iters_per_sec")
KERNELS = ("kmeans_assign_accumulate", "windowed_segsum",
           "segment_sum_block", "partition_pack", "shard_topk",
           "bincount_block", "conv_block", "fixed_order_reduce")


def test_thresholds_file_well_formed():
    with open(benchguard.THRESHOLDS_PATH) as f:
        table = json.load(f)
    assert os.path.dirname(benchguard.THRESHOLDS_PATH).endswith(
        os.path.join("spartan_tpu_torch", "utils"))
    assert "cuda" in table
    cuda = table["cuda"]
    card = cuda["card"]["nvidia_smi"]
    assert card.startswith("NVIDIA ") and card.endswith(" W")
    metrics = list(RATES) + ["ssvd_seconds", "naive_bayes_fit_ms"] + [
        f"kernel_ms:{k}" for k in KERNELS]
    for metric in metrics:
        assert metric in cuda, metric
        rule = cuda[metric]
        assert ("min" in rule) != ("max" in rule)  # exactly one bound
        (bound,) = rule.values()
        assert isinstance(bound, (int, float)) and bound > 0
        assert ("min" in rule) == (metric in RATES)
    # the swinging figures stay out of the file
    for name in cuda:
        assert "serve" not in name and "integrity" not in name


def test_check_grades_min_and_max(tmp_path):
    path = os.path.join(tmp_path, "thr.json")
    with open(path, "w") as f:
        json.dump({"cuda": {"rate": {"min": 10.0},
                            "secs": {"max": 2.0}}}, f)
    for metrics in ({"rate": 12.0, "secs": 1.5}, {"rate": 7.0, "secs": 1.5},
                    {"rate": 12.0, "secs": 9.0}):
        assert benchguard.check(metrics, "cuda", path) == bg_j.check(
            metrics, "cuda", path)
    g = benchguard.check({"rate": 12.0, "secs": 1.5}, "cuda", path)
    assert g["pass"] and g["checked"] == 2
    g = benchguard.check({"rate": 7.0, "secs": 1.5}, "cuda", path)
    assert not g["pass"]
    assert g["results"]["rate"]["pass"] is False
    assert g["results"]["secs"]["pass"] is True
    g = benchguard.check({"rate": 12.0, "secs": 9.0}, "cuda", path)
    assert not g["pass"] and g["results"]["secs"]["pass"] is False


def test_check_unknown_metric_and_platform(tmp_path):
    path = os.path.join(tmp_path, "thr.json")
    with open(path, "w") as f:
        json.dump({"cuda": {"rate": {"min": 10.0}}}, f)
    g = benchguard.check({"rate": 11.0, "new_metric": 1.0}, "cuda", path)
    assert g["pass"] and g["checked"] == 1
    assert g["results"]["new_metric"]["pass"] is None
    g = benchguard.check({"rate": 0.001}, "cpu", path)
    assert g["pass"] and g["checked"] == 0
    g = benchguard.check({"rate": 0.001}, "cuda",
                         os.path.join(tmp_path, "absent.json"))
    assert g["pass"] and g["checked"] == 0
    assert benchguard.load_thresholds("tpu") == {}


def test_check_none_value_unchecked(tmp_path):
    path = os.path.join(tmp_path, "thr.json")
    with open(path, "w") as f:
        json.dump({"cuda": {"rate": {"min": 10.0}}}, f)
    g = benchguard.check({"rate": None}, "cuda", path)
    assert g == bg_j.check({"rate": None}, "cuda", path)
    assert g["pass"] and g["checked"] == 0
    assert g["results"]["rate"]["pass"] is None


def test_current_cuda_measurements_pass_committed_floors():
    """The figures the bounds came from grade green against the
    committed file: guards the guard against over-tight bounds."""
    g = benchguard.check(MEASURED, "cuda")
    assert g["pass"] and g["checked"] == len(MEASURED)
