"""The port's examples (``examples/torch_*.py``) on the CPU, each against
what the reference's example (``examples/*.py``) prints.

Each example runs in this process (``runpy``, as a module, then its
``main`` with ``--device cpu``).  The reference's serve demo and its
quickstart up to its timing run in this process too; the reference's
fault-tolerance lines
come from its ``Supervisor`` and ``plan_elastic`` on the example's
schedule (fail at step 25, checkpoints every 10, 40 steps), without its
model.
"""
import contextlib
import io
import pathlib
import re
import runpy

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
COUNT_LINE = re.compile(r"^prefill \d+ tokens \(\d+ padded\) in \d+ chunks; "
                        r"\d+ decode steps$", re.M)


def _load(name):
    return runpy.run_path(str(EXAMPLES / name), run_name="example")


def _run(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def test_quickstart_shape_lines_equal_reference():
    rc, out = _run(_load("torch_quickstart.py")["main"], ["--device", "cpu"])
    assert rc == 0
    # the reference's script up to its throughput timing (part 4), which
    # prints nothing these lines compare
    text = (EXAMPLES / "quickstart.py").read_text()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        exec(compile(text[:text.index("# 4. throughput")], "quickstart.py",
                     "exec"), {"__name__": "__main__"})
    want = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith(("in :", "out:"))]
    got = [ln for ln in out.splitlines() if ln.startswith(("in :", "out:"))]
    assert len(want) == 2 and got == want
    assert re.search(r"^throughput: mux N=4 is [\d.]+x vanilla .*host clock",
                     out, re.M)


def test_serve_demo_counts_equal_reference():
    """The prefill-token, padded-token, chunk and decode-step counts (the
    numpy-seeded prompts and the schedule, not the weights) equal the
    reference demo's; the step signatures are its compiled programs."""
    rc, out = _run(_load("torch_serve_mux.py")["main"], ["--device", "cpu"])
    assert rc == 0
    rc_ref, ref = _run(_load("serve_mux.py")["runtime_demo"])
    assert rc_ref == 0
    assert COUNT_LINE.findall(out) == COUNT_LINE.findall(ref)
    assert len(COUNT_LINE.findall(out)) == 1
    sig = re.search(r"^step signatures: (.*)$", out, re.M).group(1)
    assert sig == re.search(r"^compiled programs: (.*)$", ref,
                            re.M).group(1)
    assert len(re.findall(r"^request \d \[", out, re.M)) == 4


def test_serve_cli_shorthand():
    mod = _load("torch_serve_mux.py")
    assert mod["launcher_argv"](["--paged", "--requests", "6"]) == [
        "--continuous", "--cache", "paged", "--block-size", "4",
        "--requests", "6"]
    assert mod["launcher_argv"](["--paged", "--block-size", "8"]) == [
        "--continuous", "--cache", "paged", "--block-size", "8"]
    rc, out = _run(mod["main"], ["--paged", "--device", "cpu", "--requests",
                                 "3", "--prompt-len", "6", "--new-tokens",
                                 "3", "--chunk", "4"])
    assert rc == 0
    assert "served 3 requests (9 tokens)" in out
    assert "step signatures: decode×1, prefill_4×1" in out


def _reference_fault_lines():
    """The restart and elastic-plan lines the reference's example prints,
    from its Supervisor over the example's schedule and its
    plan_elastic."""
    import tempfile

    import jax.numpy as jnp
    from repro.checkpoint import AsyncCheckpointManager
    from repro.runtime import DeviceFailure, Supervisor, plan_elastic
    armed = {"on": True}

    def fault(step_i):
        if step_i == 25 and armed["on"]:
            armed["on"] = False
            raise DeviceFailure("slice 2 heartbeat lost")

    with tempfile.TemporaryDirectory() as d:
        sup = Supervisor(step_fn=lambda s, b, i: (s, {"loss": 0.0}),
                         ckpt=AsyncCheckpointManager(d), checkpoint_every=10,
                         fault_hook=fault)
        with pytest.warns(UserWarning, match="no .seek"):
            _, hist = sup.run({"w": jnp.zeros(())}, iter(lambda: {}, None),
                              40)
    restarts = [h for h in hist if h.get("event") == "restart"]
    plan = plan_elastic(384, model_parallel=16, old_global_batch=256)
    return [f"finished 40 steps with {len(restarts)} restart(s); "
            f"restored from step {restarts[0]['at_step']}",
            f"elastic plan after losing 128 devices: mesh={plan.mesh_shape}, "
            f"batch {256} -> {plan.global_batch}, dropped={plan.dropped}"]


def test_fault_tolerant_training_lines_equal_reference():
    with pytest.warns(UserWarning, match="no .seek"):
        rc, out = _run(_load("torch_fault_tolerant_training.py")["main"],
                       ["--device", "cpu"])
    assert rc == 0
    lines = out.splitlines()
    assert "!!! injected device failure at step 25" in lines
    want = _reference_fault_lines()
    assert want[0] == "finished 40 steps with 1 restart(s); restored from " \
        "step 20"
    assert [ln for ln in lines if ln.startswith(("finished", "elastic"))] \
        == want


def test_train_mux_bert_short_run():
    mod = _load("torch_train_mux_bert.py")
    argv = mod["demo_argv"](["--device", "cpu", "--steps", "2",
                             "--warmup-steps", "2", "--batch", "8"])
    assert argv[:6] == ["--device", "cpu", "--steps", "2", "--warmup-steps",
                        "2"]
    assert "--model" in argv and argv.count("--batch") == 1
    rc, out = _run(mod["main"], argv)
    assert rc == 0
    assert "--- stage: retrieval-warmup (2 steps) ---" in out
    assert "--- stage: mlm-pretrain (2 steps) ---" in out
