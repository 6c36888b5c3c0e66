"""The port's examples (``examples_torch/``), each run in-process with
``--device cpu``: they run the plain transition where the card would run
the step kernel, and import no JAX."""

import os
import runpy

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("example_batched", "example_bbox", "example_bbox_mini",
            "example_correct", "example_full", "example_train_emaml")
# smaller than the card's defaults (1024 envs, 3 meta-iterations): the
# plain step on this CPU takes milliseconds per env-step
CPU_SIZE = {"example_batched": {"batch": 128},
            "example_train_emaml": {"iterations": 2}}


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_cpu(name, capsys):
    path = os.path.join(REPO, "examples_torch", f"{name}.py")
    main = runpy.run_path(path, run_name=name)["main"]
    result = main(["--device", "cpu"], **CPU_SIZE.get(name, {}))
    out = capsys.readouterr().out
    assert ("ok" in out or "solved, reward 1.0" in out
            or "total reward" in out), out
    if name == "example_correct":
        assert result == 1.0
    if name == "example_bbox_mini":
        assert result["grid"].shape == (5, 5)
    if name == "example_train_emaml":
        assert len(result) == 2 and all(
            float(m["meta_loss"]) == float(m["meta_loss"]) for m in result)
