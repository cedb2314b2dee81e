"""The port's on-chip studies (``python -m ecseg_torch.profile_*`` and
``quantify_watershed_divergence``) against the JAX repo's scripts, on the
CPU:

- each study's seeded inputs equal the JAX script's byte for byte (the
  script loaded from ``scripts/`` by importlib; an inline generator is run
  from the script's own statements);
- each ``main(device="cpu")`` at a tiny size exits 0, prints the JAX
  script's rows (minus the drops its docstring lists) and its JSON line,
  with every time null;
- ``quantify_watershed_divergence`` prints the JAX script's numbers;
- ``profile_layers``' FLOP table and recorded layouts;
- each ``python -m`` exits 1 without a card.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from ecseg_torch import (
    profile_fast_watershed,
    profile_layers,
    profile_meta_post,
    profile_metaseg_2048,
    profile_nuclei_segment,
    quantify_watershed_divergence,
)
from ecseg_torch.models import metaseg_unet
from ecseg_torch.models.metaseg_unet import MetasegUNet

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
STUDIES = ("profile_meta_post", "profile_metaseg_2048", "profile_layers", "profile_nuclei_segment",
           "profile_fast_watershed", "quantify_watershed_divergence")
META_POST_DROPS = {"label+compact_roots", "label+sort", "label+scatterLUT+gather1M", "label+eq-matmul-sums(5)"}


def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def script_main(name):
    return next(n for n in ast.parse((REPO / "scripts" / f"{name}.py").read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def run_inline_generator(name, stop):
    """Run the statements of the script's ``main`` from ``rng = ...`` to the
    one before the first that mentions ``stop``; their namespace."""
    body = script_main(name).body
    start = next(i for i, n in enumerate(body) if "rng = np.random.default_rng" in ast.unparse(n))
    end = next(i for i, n in enumerate(body) if i > start and stop in ast.unparse(n))
    ns = {"np": np}
    exec(compile(ast.Module(body[start:end], type_ignores=[]), name, "exec"), ns)
    return ns


def called_names(name, fn):
    """First arguments of the calls to ``fn`` in the script's ``main``,
    outside its ``if`` blocks (``profile_meta_post``'s ``--vmap`` rows)."""
    out = []
    for stmt in script_main(name).body:
        if isinstance(stmt, ast.If):
            continue
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == fn and node.args:
                if isinstance(node.args[0], ast.Constant):
                    out.append(node.args[0].value)
    return out


def run_cpu(module, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv, device="cpu")
    lines = buf.getvalue().splitlines()
    line = json.loads(lines[-1])
    assert rc == 0 and line["card"] is None
    for row in line["rows"]:
        assert all(row[k] is None for k in ("wall_ms", "device_ms", "ops", "syncs")), row
    return line, lines


def base(name):
    """A row name without its '(host)' / '(device)' tag."""
    return re.sub(r" \((host|device)\)$", "", name)


# --- the seeded inputs ---------------------------------------------------------


@pytest.mark.parametrize("shape, n", [((1024, 1024), 2), ((128, 96), 3)])
def test_meta_post_label_maps_equal_the_script(shape, n):
    jax_maps = jax_script("profile_meta_post")._label_maps(np.random.default_rng(0), n, shape)
    ours = profile_meta_post._label_maps(np.random.default_rng(0), n, shape)
    assert ours.dtype == jax_maps.dtype and ours.tobytes() == jax_maps.tobytes()


def test_metaseg_2048_image_equals_the_script():
    ns = run_inline_generator("profile_metaseg_2048", "im2patches_overlap")
    img = profile_metaseg_2048.make_image()
    assert img.dtype == ns["img"].dtype and img.tobytes() == ns["img"].tobytes()


def test_nuclei_segment_image_equals_the_script():
    ns = run_inline_generator("profile_nuclei_segment", "load_nuset_model")
    img = profile_nuclei_segment.make_image()
    assert img.dtype == ns["img"].dtype and img.tobytes() == ns["img"].tobytes()


@pytest.mark.parametrize("script", ["profile_fast_watershed", "quantify_watershed_divergence"])
def test_watershed_cases_equal_the_script(script):
    mod = jax_script(script)
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(3):
        for x, y in zip(mod.make_case(a), profile_fast_watershed.make_case(b)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_layers_inputs_equal_the_script(monkeypatch):
    """The JAX script's ``main`` with N=1 on its first four layers, its jit
    replaced by a capture of what each loop is given: the port's draws,
    rounded to bf16 as the script rounds them, are the same values."""
    mod = jax_script("profile_layers")
    assert profile_layers.layer_table() == mod.LAYERS
    captured = []

    def fake_jit(fn):
        def loop(x, ks):
            captured.append((np.asarray(x.astype(np.float32)), np.asarray(ks.astype(np.float32))))
            return np.float32(0)
        return loop

    clock = iter(range(1, 10 ** 6))
    monkeypatch.setattr(mod, "N", 1)
    monkeypatch.setattr(mod, "LAYERS", mod.LAYERS[:4])
    monkeypatch.setattr(mod.jax, "jit", fake_jit)
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(perf_counter=lambda: float(next(clock))))
    with contextlib.redirect_stdout(io.StringIO()):
        mod.main()
    rng = np.random.default_rng(0)
    assert len(captured) == 8  # the compile call and the timed call of each layer
    for (name, kind, h, cin, cout), (x_jax, ks_jax) in zip(mod.LAYERS[:4], captured[::2]):
        x, ks = profile_layers.layer_inputs(rng, 1, kind, h, cin, cout)
        assert torch.equal(torch.from_numpy(x).bfloat16().float(), torch.from_numpy(x_jax.copy())), name
        assert torch.equal(torch.from_numpy(ks).bfloat16().float(), torch.from_numpy(ks_jax.copy())), name


# --- profile_layers' counts and layouts ----------------------------------------


def test_layers_flops_follow_the_work():
    mod = jax_script("profile_layers")
    n = profile_layers.N
    for name, kind, h, cin, cout in mod.LAYERS:
        ours = profile_layers.flops(kind, h, cin, cout)
        want = {"pool": 0, "conv": 2 * 9 * h * h * cin * cout * n, "conv1": 2 * h * h * cin * cout * n,
                "convt": 2 * 9 * h * h * cin * cout * n}[kind]
        assert ours == want, name
        # the JAX script counts the transpose conv at its output resolution
        assert mod.flops(kind, h, cin, cout) == (4 * want if kind == "convt" else want), name


def test_recorded_layouts_match_a_forward_hook():
    """At narrow widths, the layout ``record_formats`` records for each
    layer's input equals what a forward pre-hook on the layer's module sees
    in the float32 forward (where every layer runs through its module)."""
    model = MetasegUNet((4, 8), 16, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 256, 256, 1), dtype=np.uint8))
    hooked = {}

    def hook(name):
        def record(module, args):
            hooked.setdefault(name, (str(args[0].dtype).replace("torch.", ""), profile_layers.layout(args[0])))
        return record

    handles = [layer.register_forward_pre_hook(hook(name)) for name, layer in model.layers.items()]
    with torch.no_grad():
        model(x)
    for h in handles:
        h.remove()
    recorded = profile_layers.record_formats(model, x, torch.float32)
    assert set(hooked) <= set(recorded)
    for name, (dtype, fmt) in hooked.items():
        assert (recorded[name]["dtype"], recorded[name]["input"]) == (dtype, fmt), name
    assert recorded["enc1_1"]["input"] == "both"  # the permuted one-channel input
    assert "pool1" in recorded
    bf16 = profile_layers.record_formats(MetasegUNet((4, 8), 16).to(torch.bfloat16).eval(), x, torch.bfloat16)
    assert {r["dtype"] for r in bf16.values()} == {"bfloat16"} and set(bf16) == set(recorded)


def test_recorded_formats_name_the_hand_kernel_where_the_forward_routes(monkeypatch):
    """Where the forward hands its 3x3 convs to ``conv3x3_relu`` (the
    float32 forward on the card; forced here on the CPU, where the twin
    serves it), ``record_formats`` names them ``H1`` with the second
    half's channels, and ``layer_op`` times that call on the halves; the
    transpose convs too where the batch takes them to the kernel
    (``layers.transpose_on_kernel``), and ``layer_op`` times the 3x3 conv
    of the zero-spread input."""
    from ecseg_torch.models import layers

    model = MetasegUNet((4, 8), 16, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 256, 256, 1), dtype=np.uint8))
    monkeypatch.setattr(MetasegUNet, "_kernel_route", lambda self, x, dtype: True)
    convs = {name for name, layer in model.layers.items() if layer.kernel_size == (3, 3) and layer.stride == (1, 1)}
    ups = {name for name in model.layers if name.startswith("up")}
    for limit in (0, 1):  # one patch: the transpose convs on cuDNN, then on the kernel
        monkeypatch.setattr(layers, "ZERO_SPREAD_MAX_IMAGES", limit)
        recorded = profile_layers.record_formats(model, x, torch.float32)
        h1 = {name for name, r in recorded.items() if r["op"] == "H1"}
        assert h1 == convs | (ups if limit else set())
        assert {name: r["split"] for name, r in recorded.items() if r["op"] == "H1" and r["split"]} == {"dec2_1": 8, "dec1_1": 4}
        assert {r["op"] for name, r in recorded.items() if name not in h1} == {"library"}  # pools, transpose convs, head
        assert recorded["dec1_1"]["input"] == "channels_last"
    layer = layers.TFConvTranspose2d(8, 4)
    xt = torch.from_numpy(np.random.default_rng(4).integers(-3, 4, (1, 8, 5, 6)).astype(np.float32))
    with torch.no_grad():
        got = profile_layers.layer_op("convt", xt.contiguous(memory_format=torch.channels_last), layer.weight, layer.bias, h1_split=0)()
        np.testing.assert_allclose(got.numpy(), torch.relu(layer(xt)).numpy(), atol=1e-5, rtol=0)
    xi = torch.from_numpy(np.random.default_rng(2).integers(-3, 4, (1, 8, 16, 16)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(3).integers(-3, 4, (4, 8, 3, 3)).astype(np.float32))
    b = torch.arange(4, dtype=torch.float32)
    for split in (0, 4):
        got = profile_layers.layer_op("conv", xi, w, b, h1_split=split)()
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, torch.relu(torch.nn.functional.conv2d(xi, w, b, padding=1)))


# --- each study on the CPU -----------------------------------------------------


def test_meta_post_prints_the_script_rows():
    line, _ = run_cpu(profile_meta_post, ["1", "--size", "96"])
    names = [r["name"] for r in line["rows"]]
    assert names == [n for n in called_names("profile_meta_post", "bench") if n not in META_POST_DROPS
                     ] == [n for n, _, _ in profile_meta_post.blocks(1, 1, True, False)]
    assert {r["size"] for r in line["rows"]} == {96} and all(r["checksum"] > 0 for r in line["rows"])
    # the checksums are the blocks' integer outputs: label's is a sum of labels
    m = torch.from_numpy(profile_meta_post._label_maps(np.random.default_rng(0), 1, (96, 96))[0] == 1)
    assert line["rows"][0]["checksum"] == int(profile_meta_post.label(m).long().sum())


@pytest.fixture
def narrow_unet(monkeypatch):
    """The studies read metaseg_unet's widths at each call: narrow them."""
    monkeypatch.setattr(metaseg_unet, "ENC_WIDTHS", (4, 8))
    monkeypatch.setattr(metaseg_unet, "BOTTLENECK", 16)


@pytest.fixture
def small_cases(monkeypatch):
    """128^2 cases of 6 discs from the port's make_case (its geometry
    arguments), where both watershed studies draw them."""
    make_case = profile_fast_watershed.make_case

    def small(rng):
        return make_case(rng, H=128, W=128, n=6)

    monkeypatch.setattr(profile_fast_watershed, "make_case", small)
    monkeypatch.setattr(quantify_watershed_divergence, "make_case", small)


def test_metaseg_2048_prints_its_rows(narrow_unet):
    line, lines = run_cpu(profile_metaseg_2048, ["--size", "256", "--reps", "1"])
    names = [(r["name"], r["dtype"]) for r in line["rows"]]
    assert names == [(n, d) for d in ("float32", "bfloat16") for n in ("forward", "stitch", "post", "fetch")] + [
        ("steady-state image", "float32"), ("steady-state image", "bfloat16")]
    image = line["rows"][-2]
    assert image["ok"] is True and image["labels"] == [256, 256] and set(image["classes"]) <= {0, 1, 2, 3}
    assert any(ln.startswith("ok=True num_ec=") for ln in lines) and line["patches"] == 1


def test_layers_prints_the_script_rows(narrow_unet):
    line, _ = run_cpu(profile_layers, ["--n", "1", "--dtype", "float32"])
    table = profile_layers.layer_table((4, 8), 16)
    assert [r["name"] for r in line["rows"]] == [t[0] for t in table] + ["forward"]
    assert [t[0] for t in profile_layers.layer_table()] == [t[0] for t in jax_script("profile_layers").LAYERS]
    assert all(r["layout_in"] for r in line["rows"][:-1]) and line["formats"]["float32"]["enc1_1"]["input"] == "both"


def test_nuclei_segment_prints_the_script_rows():
    line, _ = run_cpu(profile_nuclei_segment, ["--size", "256", "--reps", "1"])
    ours = [base(r["name"]) for r in line["rows"]]
    jax_rows = [base(n) for n in called_names("profile_nuclei_segment", "t")]
    assert [n for n in ours if n != "cleanup_pass"] == jax_rows
    total = line["rows"][0]
    assert total["name"] == "nuclei_segment TOTAL" and total["foreground"] == line["rows"][6]["foreground"]


def test_fast_watershed_prints_its_rows(small_cases):
    line, _ = run_cpu(profile_fast_watershed, ["--reps", "1"])
    rows = {r["name"]: r for r in line["rows"]}
    assert list(rows) == ["host", "device", "auto", "lex_flood"]
    assert all(0.9 < a <= 1 for a in rows["device"]["agreement"])
    assert rows["auto"]["kept"] == len(rows["auto"]["agreement_kept"]) and all(a == 1 for a in rows["auto"]["agreement_kept"])
    assert rows["lex_flood"]["converged"] is True


def test_quantify_equals_the_script(monkeypatch, small_cases):
    """N = 2 on 128^2 cases of 6 discs: the port's per-case and summary
    lines equal the JAX script's ``main`` (its ``make_case`` narrowed the
    same way), letter for letter."""
    mod = jax_script("quantify_watershed_divergence")
    make_case = mod.make_case
    monkeypatch.setattr(mod, "make_case", lambda rng: make_case(rng, H=128, W=128, n=6))
    monkeypatch.setattr(sys, "argv", ["quantify_watershed_divergence.py", "2"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    want = buf.getvalue().splitlines()
    line, got = run_cpu(quantify_watershed_divergence, ["2"])
    assert got[:-1] == want
    assert [r["divergent_px"] for r in line["rows"]] == [int(re.search(r"divergent_px= *(\d+)", w).group(1))
                                                        for w in want if w.startswith("case ")]


def test_studies_exit_1_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = {name: subprocess.Popen([sys.executable, "-m", f"ecseg_torch.{name}"], cwd=REPO, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for name in STUDIES}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 1 and out == "", (name, err)
        assert err.strip() == f"{name}: no CUDA device is available; aborting without a result"
