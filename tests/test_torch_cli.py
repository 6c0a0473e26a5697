"""The port's training CLI on the CPU (``--device cpu``): the reference's
flags and defaults, its console lines, checkpoints and ``--eval-only``,
and a one-line exit naming the ROADMAP item for every flag whose path is
not ported."""

import re

import pytest
import torch

from simple_distributed_machine_learning_tpu.cli import (
    build_parser as jax_parser,
)
from simple_distributed_machine_learning_tpu_torch.cli import (
    build_parser,
    main,
)
from simple_distributed_machine_learning_tpu_torch.ops import (
    flash_attention as fa,
)

TRAIN_RE = re.compile(
    r"^Train Epoch: (\d+) \[(\d+)/(\d+) \((\d+)%\)\]\tLoss: (\d+\.\d{6})$")
TEST_RE = re.compile(
    r"^Test set: Average loss: (\d+\.\d{4}), Accuracy: (\d+)/(\d+) "
    r"\((\d+)%\)$")
EPOCH_RE = re.compile(r"^\| epoch (\d+): (\d+\.\d) samples/sec$")
BASE = ["--rank", "0", "--world_size", "1", "--device", "cpu",
        "--data-root", "/nonexistent"]


def _reference_lines(out):
    lines = [l for l in out.split("\n") if l]
    assert all(TRAIN_RE.match(l) or TEST_RE.match(l) or EPOCH_RE.match(l)
               for l in lines), lines
    return lines


def test_ported_flags_and_defaults_equal_the_jax_parser():
    ours = vars(build_parser().parse_args(["--rank", "0"]))
    ref = vars(jax_parser().parse_args(["--rank", "0"]))
    assert ours.pop("device") is None        # the port's own flag
    assert ours == ref
    # the choices of every shared option are the reference's too
    theirs = {a.dest: a.choices for a in jax_parser()._actions}
    for a in build_parser()._actions:
        if a.dest in theirs:
            assert a.choices == theirs[a.dest], a.dest


@pytest.mark.parametrize("model,extra,n_train_lines", [
    ("lenet", ["--dryrun", "2"], 1),
    ("mlp", ["--mlp-dims", "784,32,10", "--dryrun", "12"], 2),
    ("mlp", ["--mlp-dims", "784,32,10", "--dryrun", "3", "--bf16"], 1),
    ("lenet", ["--dryrun", "2", "--bf16"], 1),
    ("mlp", ["--mlp-dims", "784,32,10", "--epochs", "2",
             "--max-steps-per-epoch", "3", "--optimizer", "adamw",
             "--lr", "1e-3", "--lr-schedule", "warmup-cosine",
             "--warmup-steps", "2", "--clip-norm", "1.0", "--zero1",
             "--shuffle"], 2),
])
def test_cli_runs_on_the_cpu(capsys, model, extra, n_train_lines):
    main(BASE + ["--model", model] + extra)
    lines = _reference_lines(capsys.readouterr().out)
    assert len([l for l in lines if TRAIN_RE.match(l)]) == n_train_lines
    assert lines[0] == "Train Epoch: 1 [0/6000 (0%)]" + lines[0][28:]
    tests = [TEST_RE.match(l) for l in lines if TEST_RE.match(l)]
    assert tests and tests[-1].group(3) == "1000"


def test_cli_mlp_learns(capsys):
    main(BASE + ["--model", "mlp", "--mlp-dims", "784,32,10", "--dryrun",
                 "40"])
    acc = int(re.findall(r"Accuracy: (\d+)/1000", capsys.readouterr().out)[0])
    assert acc > 500                             # chance is 100


def test_cli_gpt_flash_dryrun_goes_through_the_flash_wrappers(capsys):
    fa.flash_forward.launches = fa.flash_dq.launches = 0
    fa.flash_dkv.launches = 0
    main(BASE + ["--model", "gpt", "--attn", "flash", "--dryrun", "2",
                 "--generate", "4"])
    out = capsys.readouterr().out
    assert "Train Epoch: 1 [0/6000 (0%)]" in out
    assert "Test set: Average loss:" in out
    assert re.search(r"\| sample tokens \(prompt 16 \+ 4 generated\): "
                     r"\[(\d+, ){19}\d+\]", out)
    # on the CPU the wrappers run their plain versions and count nothing
    assert (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == (0, 0, 0)


def test_cli_gpt_text_corpus(tmp_path, capsys):
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(b"the quick brown fox jumps over the lazy dog. " * 40)
    main(BASE + ["--model", "gpt", "--text-corpus", str(corpus),
                 "--dryrun", "1", "--batch-size", "8", "--generate", "3"])
    out = capsys.readouterr().out
    assert "| sample (16-byte prompt + 3 generated):" in out


def test_cli_checkpoint_resume_and_eval_only(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = BASE + ["--model", "mlp", "--mlp-dims", "784,32,10",
                   "--max-steps-per-epoch", "5", "--checkpoint-dir", ck]
    main(args + ["--epochs", "1", "--async-checkpoint"])
    trained = capsys.readouterr().out
    main(args + ["--epochs", "2"])
    out = capsys.readouterr().out
    assert f"| resumed from {ck}/state.npz at epoch 2 (step 5)" in out
    assert "Train Epoch: 2 [0/6000 (0%)]" in out
    assert "Train Epoch: 1" not in out
    final = re.findall(r"Accuracy: (\d+)/", out)[-1]
    main(args + ["--epochs", "2", "--eval-only"])
    out = capsys.readouterr().out
    assert "Train Epoch" not in out
    assert re.findall(r"Accuracy: (\d+)/", out)[-1] == final
    assert re.findall(r"Accuracy: (\d+)/", trained)
    # --no-resume ignores the checkpoint, and --eval-only on an empty dir
    # says it evaluates fresh weights
    main(args + ["--epochs", "1", "--no-resume"])
    assert "resumed" not in capsys.readouterr().out
    main(BASE + ["--model", "mlp", "--mlp-dims", "784,32,10", "--eval-only",
                 "--checkpoint-dir", str(tmp_path / "empty")])
    assert "no checkpoint found" in capsys.readouterr().out


def test_cli_metrics_json(tmp_path):
    path = tmp_path / "m.jsonl"
    main(BASE + ["--model", "mlp", "--mlp-dims", "784,32,10", "--epochs",
                 "2", "--max-steps-per-epoch", "2", "--metrics-json",
                 str(path)])
    assert len(path.read_text().splitlines()) == 2


@pytest.mark.parametrize("flag,item", [
    (["--stages", "2"], "item 6"),
    (["--world_size", "2"], "item 6"),
    (["--dp", "2"], "item 6"),
    (["--tp", "2"], "item 6"),
    (["--sp", "2"], "item 6"),
    (["--ep", "2"], "item 6"),
    (["--experts", "4"], "item 6"),
    (["--overlap", "ring"], "item 6"),
    (["--remat"], "item 6"),
    (["--sentinel"], "item 6"),
    (["--telemetry-dir", "/tmp/t"], "item 6"),
    (["--profile", "/tmp/p"], "item 6"),
    (["--scenario", "crash-serve"], "item 4"),
    (["--chaos", "host-kill@train.step=6"], "item 4"),
    (["--serve-sim", "8"], "item 4"),
    (["--serve-trace"], "item 4"),
    (["--serve-replicas", "2"], "item 4"),
    (["--serve-spec-k", "2"], "item 5"),
    (["--serve-adapters", "2"], "item 5"),
    (["--lint"], "item 7"),
    (["--lint-only"], "item 7"),
])
def test_unported_flags_exit_naming_their_item(flag, item):
    with pytest.raises(SystemExit) as e:
        main(BASE + flag)
    msg = str(e.value)
    assert f"ROADMAP.md, Queue A: {item}" in msg and flag[0] in msg
    assert "\n" not in msg


@pytest.mark.parametrize("argv,match", [
    (["--dryrun", "-1"], "non-negative"),
    (["--model", "mlp", "--generate", "3"], "only supported with"),
    (["--max-steps-per-epoch", "0"], ">= 1"),
    (["--model", "gpt", "--flash-blocks", "16,16"], "needs --attn flash"),
    (["--model", "gpt", "--attn", "flash", "--flash-blocks", "x"],
     "Q,K integers"),
])
def test_bad_values_exit_with_one_line(argv, match):
    with pytest.raises(SystemExit, match=match):
        main(BASE + argv)


def test_rank_required_for_multiprocess():
    with pytest.raises(SystemExit, match="Must provide rank"):
        main(["--world_size", "2", "--device", "cpu"])


def test_without_device_and_without_cuda_the_cli_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--rank", "0", "--world_size", "1", "--model", "lenet",
              "--dryrun", "2", "--data-root", "/nonexistent"])
