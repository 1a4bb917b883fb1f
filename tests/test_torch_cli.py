"""The port's command-line trainer, ``enhancing_tpu_torch.main``, on the CPU.

``main(argv)`` trains ``configs/fake_vitvq_tiny.yaml`` and
``configs/fake_gpt_tiny.yaml`` for 2 steps into a run directory, then
``--resume`` goes on from the epoch-0 checkpoint. The CLI reads
``configs/<name>.yaml`` in the working directory, so the tests run it in a
temporary one whose copies of the two configs (written with the port's
YAML writer) differ from the shipped files only in the tokenizer's loader:
batch 4 and 4 validation images (the StyleGAN discriminator's steps take
seconds on one CPU thread). The run directory's
``config.yaml``, ``metrics.jsonl`` and image grids are held to what the
JAX package's ``SetupCallback``, ``JsonlLogger`` and ``save_image_grid``
write; every flag for several cards raises naming ROADMAP A9, and
``--compile_cache`` names the port's kernel build directory.
"""
import argparse
import contextlib
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from enhancing_tpu.utils.callback import SetupCallback as JaxSetupCallback
from enhancing_tpu.utils.config import load_config as jax_load_config
from enhancing_tpu.utils.logging import JsonlLogger as JaxJsonlLogger
from enhancing_tpu.utils.logging import save_image_grid as jax_save_grid
from enhancing_tpu_torch import main as cli
from enhancing_tpu_torch.utils import yaml_io
from enhancing_tpu_torch.utils.callback import ImageLogger
from enhancing_tpu_torch.utils.config import remap_targets
from enhancing_tpu_torch.utils.logging import save_image_grid

REPO = Path(__file__).resolve().parents[1]
CONFIGS = ("fake_vitvq_tiny", "fake_gpt_tiny")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cut_configs(workdir: Path) -> None:
    """``workdir/configs`` with the two configs, the tokenizer's loader cut
    to batch 4 and 4 validation images, and ``workdir/assets``."""
    (workdir / "configs").mkdir()
    for name in CONFIGS:
        cfg = yaml.safe_load((REPO / "configs" / f"{name}.yaml").read_text())
        if name == "fake_vitvq_tiny":
            cfg["dataset"]["params"]["batch_size"] = 4
            cfg["dataset"]["params"]["validation"]["params"]["length"] = 4
        yaml_io.dump(cfg, workdir / "configs" / f"{name}.yaml")
    (workdir / "assets").symlink_to(REPO / "assets")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per config: (run dir, trainers of the two calls, what the resumed
    call printed, the working directory)."""
    out = {}
    cwd = os.getcwd()
    workdir = tmp_path_factory.mktemp("cwd")
    cut_configs(workdir)
    os.chdir(workdir)
    try:
        for name in CONFIGS:
            run = tmp_path_factory.mktemp(name)
            argv = ["-c", name, "--device", "cpu", "--run_dir", str(run),
                    "--log_every", "1"]
            first = cli.main(argv + ["--max_steps", "2"])
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                second = cli.main(argv + ["--max_steps", "3", "--resume"])
            out[name] = (run, first, second, buf.getvalue(), workdir)
    finally:
        os.chdir(cwd)
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_cli_trains_then_resumes(runs, name):
    run, first, second, printed, _ = runs[name]
    assert first.global_step == 2 and second.global_step == 3
    assert "[resume] epoch-0 checkpoint restored (global step 2)" in printed
    assert sorted(os.listdir(run / "ckpt")) == ["0", "1"]
    assert (run / "ckpt" / "1" / "state.pt").is_file()
    # the first validation batch of each epoch logs its grids, named by
    # global step, as the JAX ImageLogger names them
    grids = sorted(os.listdir(run / "log" / "results" / "val"))
    tags = (["originals", "reconstructions"] if name == "fake_vitvq_tiny"
            else ["conditions", "first_samples", "second_samples"])
    assert grids == sorted(f"{t}_step{s:08d}.png" for t in tags
                           for s in (2, 3))


@pytest.mark.parametrize("name", CONFIGS)
def test_run_dir_written_as_jax_writes_it(runs, name, tmp_path):
    run, workdir = runs[name][0], runs[name][4]
    got = yaml.safe_load((run / "config.yaml").read_text())
    # JAX's SetupCallback on the same config and experiment settings
    jax_cfg = jax_load_config(workdir / "configs" / f"{name}.yaml")
    JaxSetupCallback(jax_cfg.to_dict(), got["exp_config"],
                     tmp_path).on_fit_start()
    want = yaml.safe_load((tmp_path / "config.yaml").read_text())
    assert got == {"config": remap_targets(want["config"]),
                   "exp_config": want["exp_config"]}
    assert got["exp_config"] == {
        "name": name, "epochs": 100, "update_every": 1, "base_lr": 4.5e-6,
        "use_amp": False, "batch_frequency": 750, "max_images": 4}
    assert sorted(os.listdir(run)) == ["ckpt", "config.yaml", "log",
                                       "metrics.jsonl"]

    text = (run / "metrics.jsonl").read_text()
    rows = [json.loads(line) for line in text.splitlines()]
    # steps 1, 2, epoch 0's validation, step 3, epoch 1's validation
    assert [r["step"] for r in rows] == [1, 2, 2, 3, 3]
    assert all(isinstance(r["step"], int) for r in rows)
    assert any(k.startswith("val/") for k in rows[2])
    jax_log = JaxJsonlLogger(str(tmp_path / "jax_metrics"))
    for r in rows:
        jax_log.log_metrics({k: v for k, v in r.items() if k != "step"},
                            r["step"])
    assert jax_log.path.read_text() == text


def test_image_grid_png_equals_jax_pillow_grid(tmp_path):
    """The PNG written with zlib decodes (Pillow) to JAX's Pillow grid."""
    rng = np.random.default_rng(0)
    for shape, nrow in (((5, 9, 7, 3), 4), ((3, 8, 8, 1), 2)):
        images = rng.random(shape, dtype=np.float32) * 1.2 - 0.1
        save_image_grid(torch.from_numpy(images), tmp_path / "port.png",
                        nrow=nrow)
        jax_save_grid(images, tmp_path / "jax.png", nrow=nrow)
        got = np.asarray(Image.open(tmp_path / "port.png"))
        want = np.asarray(Image.open(tmp_path / "jax.png"))
        np.testing.assert_array_equal(got, want)


def test_image_logger_ladder():
    il = ImageLogger(batch_frequency=750)
    assert il.log_steps == [64, 128, 256, 512]
    hits = [s for s in range(1, 1600) if il.check_frequency(s)]
    assert hits == [64, 128, 256, 512, 750, 1500]


REFUSED = {
    "-mp": ["-mp", "2"], "-pp": ["-pp", "2"],
    "--microbatches": ["-pp", "2", "--microbatches", "4"],
    "--zero1": ["--zero1"], "--sp": ["--sp"], "-nn": ["-nn", "2"],
    "-ng": ["-ng", "2"], "--coordinator": ["--coordinator", "host:1234"],
    "--process_id": ["--process_id", "0"],
}


@pytest.mark.parametrize("flag", sorted(REFUSED))
def test_multi_card_flags_raise_naming_a9(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        cli.main(["-c", "fake_vitvq_tiny", "--device", "cpu",
                  *REFUSED[flag]])


def test_compile_cache_raises_naming_the_build_directory():
    with pytest.raises(NotImplementedError, match="build/kernels-<digest>"):
        cli.main(["-c", "fake_vitvq_tiny", "--device", "cpu",
                  "--compile_cache", "/tmp/cc"])


def test_default_device_needs_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(REPO)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["-c", "fake_vitvq_tiny", "--max_steps", "1"])


def test_resume_without_run_dir_takes_the_newest_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = argparse.Namespace(run_dir=None, resume=True, config="cfg")
    assert cli.run_dir(args, "now") == Path("experiments/cfg/now")
    for i, name in enumerate(["01012027_000000", "31122026_000000"]):
        d = tmp_path / "experiments" / "cfg" / name
        d.mkdir(parents=True)
        os.utime(d, (1000 + i, 1000 + i))
    # newest by mtime, not by name
    assert cli.run_dir(args, "now") == Path(
        "experiments/cfg/31122026_000000")
    args.resume = False
    assert cli.run_dir(args, "now") == Path("experiments/cfg/now")


def test_chip_smoke_cli_configs_cut_only_the_sizes(tmp_path):
    """``chip_smoke.py`` phase 19's working directory: the shipped configs
    with only its cuts, read back by ``load_config``, and its PNG folder
    readable as an ImageNet validation split."""
    import importlib.util

    from enhancing_tpu_torch.data import ImageNetValidation
    from enhancing_tpu_torch.utils.config import load_config
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.cli_configs(tmp_path, "ref.ckpt")

    def shipped(name):
        return yaml.safe_load((REPO / "configs" / f"{name}.yaml").read_text())

    def cut(name):
        return yaml.safe_load((tmp_path / "configs" /
                               f"{name}_cli.yaml").read_text())

    want = shipped("fake_vitvq_base")
    for split in ("train", "validation"):
        want["dataset"]["params"][split]["params"]["length"] = 16
    assert cut("fake_vitvq_base") == want
    folder = {"target": "enhancing_tpu.data.imagenet.ImageNetValidation",
              "params": {"root": str(tmp_path / "imagenet"),
                         "resolution": 256}}
    want = shipped("imagenet_vitvq_base")
    want["dataset"]["params"].pop("train")
    want["dataset"]["params"]["validation"] = folder
    assert cut("imagenet_vitvq_base") == want
    want = shipped("imagenet_gpt_vitvq_base")
    p = want["model"]["params"]
    p["transformer"]["params"]["n_layers"] = smoke.CLI_PRIOR_LAYERS
    p["stage1"]["params"]["path"] = "ref.ckpt"
    p["cond"]["params"]["class_name"] = str(REPO / "assets" / "class" /
                                            "imagenet.txt")
    want["dataset"]["params"].pop("train")
    want["dataset"]["params"]["validation"] = folder
    want["dataset"]["params"]["batch_size"] = 8
    assert cut("imagenet_gpt_vitvq_base") == want
    for name in ("fake_vitvq_base", "imagenet_vitvq_base",
                 "imagenet_gpt_vitvq_base"):
        load_config(tmp_path / "configs" / f"{name}_cli.yaml")
    ds = ImageNetValidation(str(tmp_path / "imagenet"), resolution=256)
    assert len(ds) == smoke.CLI_IMAGES
    assert ds[0]["image"].shape == (256, 256, 3)


def test_amp_flag_sets_bf16_as_jax_does(tmp_path, monkeypatch):
    """``-a`` writes bf16 into the model's and its discriminator's params,
    as the JAX CLI does (``-e 0``: the run directory, no step)."""
    monkeypatch.chdir(REPO)
    trainer = cli.main(["-c", "fake_vitvq_tiny", "--device", "cpu", "-a",
                        "-e", "0", "--run_dir", str(tmp_path)])
    assert trainer.global_step == 0 and trainer.use_amp
    got = yaml.safe_load((tmp_path / "config.yaml").read_text())
    params = got["config"]["model"]["params"]
    assert params["dtype"] == "bfloat16"
    assert params["loss"]["params"]["disc_params"] == {"dtype": "bfloat16"}
    assert got["exp_config"]["use_amp"] is True


def test_setup_callbacks_and_profiler(tmp_path):
    from enhancing_tpu.utils.general import \
        setup_callbacks as jax_setup_callbacks
    from enhancing_tpu_torch.train.profiler import StepTimer, trace
    from enhancing_tpu_torch.utils.callback import SetupCallback
    from enhancing_tpu_torch.utils.general import set_seed, setup_callbacks
    exp = {"name": "cfg", "batch_frequency": 100, "max_images": 2}
    (setup, image), logger, basedir = setup_callbacks(exp, {"a": 1},
                                                      str(tmp_path))
    jax_cbs, _, jax_dir = jax_setup_callbacks(exp, {"a": 1}, str(tmp_path))
    assert isinstance(setup, SetupCallback)
    assert basedir.parent == jax_dir.parent == tmp_path / "cfg"
    assert (image.batch_frequency, image.max_images, image.log_steps) == (
        100, 2, [64]) == (jax_cbs[1].batch_frequency,
                          jax_cbs[1].max_images, jax_cbs[1].log_steps)
    assert not logger.enabled or logger.run is not None
    set_seed(3)
    a = np.random.random()
    set_seed(3)
    assert np.random.random() == a

    timer = StepTimer(window=4, batch_size=8)
    with trace(str(tmp_path / "trace")):
        for _ in range(3):
            torch.ones(64, 64) @ torch.ones(64, 64)
            timer.tick()
    assert timer.steps_per_sec > 0 and "images/s" in timer.summary()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])
    with trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
