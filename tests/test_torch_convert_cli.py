"""The port's convert CLI (a reference-layout model.pth -> a port capsule, and
--export back out) against the root convert.py of the JAX package, from the
same weights, on the CPU at a narrow width (32x32)."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convert as jax_convert
from pytorch_nested_unet_tpu.training import checkpoint as jax_checkpoint
from pytorch_nested_unet_tpu.training.loop import make_predict_fn as jax_make_predict_fn
from pytorch_nested_unet_tpu.utils.torch_convert import converters_for_arch
from pytorch_nested_unet_tpu_torch import convert as pconvert
from pytorch_nested_unet_tpu_torch.infer import Predictor
from pytorch_nested_unet_tpu_torch.models import create_model, parse_arch_kwargs

CASES = {  # arch -> (--arch_kwargs, keys the reference never checkpoints)
    "UNet": ('{"nb_filter": [4, 8, 16, 32, 64]}', None),
    "UNetRNNAttention": ('{"feature_scale": 16}', ("attention_block",)),
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _reference_pth(path, arch):
    """A reference-layout model.pth as the JAX package's exporter writes it
    (from the JAX import of a seeded port init), saved through
    nn.DataParallel (`module.` keys), without the tensors the reference
    builds inside forward."""
    kw, unsaved = CASES[arch]
    model = create_model(arch, 1, 3, False, generator=torch.Generator().manual_seed(5),
                         **parse_arch_kwargs(arch, kw))
    to_jax, to_torch = converters_for_arch(arch)
    sd = to_torch(to_jax({k: v.numpy() for k, v in model.state_dict().items()}))
    torch.save({"module." + k: torch.from_numpy(np.array(v)) for k, v in sd.items()
                if not (unsaved and k.startswith(unsaved))}, path)
    return sd


def _argv(pth, arch, out_dir, name):
    return ["--pth", str(pth), "--arch", arch, "--arch_kwargs", CASES[arch][0], "--input_w",
            "32", "--input_h", "32", "--dataset", "synth", "--name", name, "--output_dir",
            str(out_dir)]


@pytest.fixture(scope="module", params=sorted(CASES))
def imported(request, tmp_path_factory):
    """The same reference .pth through both CLIs, into root/jax and
    root/port: (root, arch, exporter's sd, what each printed)."""
    arch = request.param
    root = tmp_path_factory.mktemp(f"convert_{arch}")
    sd = _reference_pth(root / "ref.pth", arch)
    printed = []
    for cli, out_dir, argv in ((jax_convert, "jax", ["--platform", "cpu"]),
                               (pconvert, "port", [])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(_argv(root / "ref.pth", arch, root / out_dir, "run") + argv)
        printed.append(out.getvalue())
    return root, arch, sd, printed


def test_import_predicts_as_the_jax_import(imported):
    """Both capsules give the same probabilities within 1e-5 (UNetRNNAttention's
    attention synthesized from each framework's own init at gamma 0, where it
    adds nothing); the port's config.yml has the JAX capsule's keys."""
    root, arch, _, printed = imported
    images = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    model, variables, config = jax_checkpoint.load_capsule(str(root / "jax" / "run"))
    want = np.asarray(jax_make_predict_fn(model, False)(
        variables["params"], variables["batch_stats"], jnp.asarray(images)))
    pred, port_config = Predictor.from_capsule(str(root / "port" / "run"), batch_size=2,
                                               device="cpu")
    np.testing.assert_allclose(pred.predict_u8(images), want, atol=1e-5, rtol=0)
    assert port_config == config
    synth = [[line for line in out.splitlines() if line.startswith("synthesized")]
             for out in printed]
    assert synth[0] == synth[1] and len(synth[0]) == (arch == "UNetRNNAttention")
    if arch == "UNetRNNAttention":
        gammas = {k: v for k, v in pred.model.state_dict().items() if k.endswith("gamma")}
        assert gammas and all(float(v.abs().max()) == 0.0 for v in gammas.values())


def test_export_matches_the_jax_export(imported, tmp_path):
    """--export of each capsule: the same keys; the same values but for the
    synthesized attention tensors, which each framework draws from its own
    init (their gammas are 0 in both)."""
    root, arch, sd, _ = imported
    port = torch.load(pconvert.main(["--export", "--name", "run", "--output_dir",
                                     str(root / "port"), "--out", str(tmp_path / "p.pth")]))
    ref = torch.load(jax_convert.main(["--export", "--name", "run", "--output_dir",
                                       str(root / "jax"), "--out", str(tmp_path / "j.pth"),
                                       "--platform", "cpu"]))
    assert sorted(port) == sorted(ref) == sorted(sd)
    unsaved = CASES[arch][1]
    for k in ref:
        assert port[k].dtype == ref[k].dtype == torch.float32 and port[k].shape == ref[k].shape
        if not (unsaved and k.startswith(unsaved)) or k.endswith("gamma"):
            torch.testing.assert_close(port[k], ref[k], rtol=0, atol=0, msg=k)


def test_a_wrong_key_exits(tmp_path):
    _reference_pth(tmp_path / "ref.pth", "UNet")
    sd = torch.load(tmp_path / "ref.pth")
    sd["module.conv9_9.conv1.weight"] = sd.pop("module.conv0_0.conv1.weight")
    torch.save(sd, tmp_path / "bad.pth")
    with pytest.raises(SystemExit, match=r"missing \(1\): \['conv0_0.conv1.weight'\].*\n.*"
                                         r"unexpected \(1\): \['conv9_9.conv1.weight'\]"):
        pconvert.main(_argv(tmp_path / "bad.pth", "UNet", tmp_path / "m", "bad"))
    with pytest.raises(SystemExit, match=r"shape mismatch final\.weight"):
        pconvert.main(_argv(tmp_path / "ref.pth", "UNet", tmp_path / "m", "nc2")
                      + ["--num_classes", "2"])
    with pytest.raises(SystemExit, match="--refine_pth only applies"):
        pconvert.main(_argv(tmp_path / "ref.pth", "UNet", tmp_path / "m", "r")
                      + ["--refine_pth", str(tmp_path / "ref.pth")])


def test_psp_hybrid_synthesizes_or_grafts_the_refinement_network(tmp_path, capsys):
    """A UNetRNNPSP reference checkpoint carries no `psp.*`: the import fills
    the refinement network from the init (saying so), or from CascadePSP
    weights with --refine_pth (here another seed's refinement network, in
    the released checkpoint's keys); --export drops it again."""
    kw = {"feature_scale": 16}
    models = [create_model("UNetRNNPSP", 1, 3, False, generator=torch.Generator().manual_seed(s),
                           **kw) for s in (5, 6)]
    trunk = {k: v for k, v in models[0].state_dict().items() if not k.startswith("psp.")}
    torch.save({"module." + k: v for k, v in trunk.items()}, tmp_path / "ref.pth")
    released = {k[len("psp."):]: v for k, v in models[1].state_dict().items()
                if k.startswith("psp.")}
    torch.save(released, tmp_path / "cascadepsp.pth")
    argv = ["--pth", str(tmp_path / "ref.pth"), "--arch", "UNetRNNPSP", "--arch_kwargs",
            '{"feature_scale": 16}', "--output_dir", str(tmp_path / "m")]
    pconvert.main(argv + ["--name", "synth"])
    assert f"synthesized {len(released)} refinement tensors" in capsys.readouterr().out
    pconvert.main(argv + ["--name", "graft", "--refine_pth", str(tmp_path / "cascadepsp.pth")])
    assert "grafted CascadePSP refinement weights" in capsys.readouterr().out
    got = torch.load(tmp_path / "m" / "graft" / "model.pth")
    for k, v in trunk.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    for k, v in released.items():
        torch.testing.assert_close(got["psp." + k], v, rtol=0, atol=0)
    out = pconvert.main(["--export", "--name", "graft", "--output_dir", str(tmp_path / "m"),
                         "--out", str(tmp_path / "export.pth")])
    assert sorted(torch.load(out)) == sorted(trunk)
    del released["feats.conv1.weight"]  # an incomplete graft exits
    torch.save(released, tmp_path / "cascadepsp.pth")
    with pytest.raises(SystemExit, match=r"missing \(1\): \['psp.feats.conv1.weight'\]"):
        pconvert.main(argv + ["--name", "bad", "--refine_pth", str(tmp_path / "cascadepsp.pth")])


def test_a_checkpoint_with_a_state_dict_entry_imports_its_state_dict(tmp_path):
    """{'state_dict': sd, ...} (a training checkpoint) imports as sd does."""
    _reference_pth(tmp_path / "ref.pth", "UNet")
    torch.save({"state_dict": torch.load(tmp_path / "ref.pth"), "epoch": 7},
               tmp_path / "ckpt.pth")
    for pth, name in (("ref.pth", "a"), ("ckpt.pth", "b")):
        pconvert.main(_argv(tmp_path / pth, "UNet", tmp_path / "m", name))
    a, b = (torch.load(tmp_path / "m" / n / "model.pth") for n in "ab")
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
