"""The rest of the serving surface on the CPU: the `torch_pad` resampling
against the JAX blocks, the HTTP front end, the export artifact and the
dataset preview.

The torch_pad blocks and DynamicUNet(torch_pad=True) run on numpy-seeded
weights carried across, fp32: rel ≤ 1e-5 (measured ≤ 8e-7 for the blocks).
The HTTP server and the export run over a tiny Enhancer (DynamicUNet ch 32,
mult (1, 2), 1 res block, T 20, 16², fp32, DPM++2M with 3 steps) on the CPU,
where the attention op takes its plain version. The exported program must
give the Enhancer's bytes on the same noise exactly: it runs the same ops
on the same inputs.
"""

import json
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    TINY, SIZE, one_torch_thread, random_params, rel_err, to_port)
from hybrid_diffusion_tpu.models import DynamicUNet as JaxUNet
from hybrid_diffusion_tpu.models.blocks import DownSample as JaxDown
from hybrid_diffusion_tpu.models.blocks import UpSample as JaxUp
from hybrid_diffusion_tpu_torch import serve_http
from hybrid_diffusion_tpu_torch.config import Config
from hybrid_diffusion_tpu_torch.data import BatchLoader
from hybrid_diffusion_tpu_torch.data.datasets import SyntheticPairedDataset
from hybrid_diffusion_tpu_torch.data.registry import _png_bytes, _png_decode
from hybrid_diffusion_tpu_torch.data.visualize import plot_batch_grid
from hybrid_diffusion_tpu_torch.models import DynamicUNet
from hybrid_diffusion_tpu_torch.models.blocks import DownSample, UpSample
from hybrid_diffusion_tpu_torch.serve import (
    Enhancer,
    export_enhancer,
    load_exported,
)
from hybrid_diffusion_tpu_torch.train.loop import build_model
from hybrid_diffusion_tpu_torch.weights import save_npz_state_dict

ROOT = Path(__file__).resolve().parent.parent
SERVE = dict(T=20, channel=32, channel_mult=(1, 2), num_res_blocks=1,
             img_size=16, bf16=False, sampler="dpm++2m", ddim_step=3,
             device="cpu")


@pytest.mark.parametrize("torch_pad", [True, False])
@pytest.mark.parametrize("blocks", [(JaxDown, DownSample), (JaxUp, UpSample)],
                         ids=["down", "up"])
def test_resampling_blocks_match_jax(blocks, torch_pad):
    jax_cls, port_cls = blocks
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 32)).astype(
        np.float32)
    jm = jax_cls(torch_pad=torch_pad)
    params = jax.tree_util.tree_map(jnp.asarray, random_params(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2))
    tm = port_cls(32, torch_pad=torch_pad)
    tm.load_state_dict(to_port(params), strict=True)
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-5


def test_torch_pad_unet_matches_jax_and_shifts():
    """DynamicUNet(torch_pad=True) against JAX's on the same weights; the
    SAME model gives other values (the one-pixel phase shift)."""
    jm = JaxUNet(**TINY, dropout=0.0, torch_pad=True)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, SIZE, SIZE, 6)),
                              jnp.zeros((1,), jnp.int32))
    params = jax.tree_util.tree_map(jnp.asarray, random_params(template, 9))
    tm, same = DynamicUNet(**TINY, torch_pad=True), DynamicUNet(**TINY)
    tm.load_state_dict(to_port(params), strict=True)
    same.load_state_dict(to_port(params), strict=True)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 6)).astype(np.float32)
    t = np.array([3, 11])
    want = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t))
        other = same(torch.from_numpy(x), torch.from_numpy(t))
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-5
    assert rel_err(other.numpy(), np.asarray(want)) > 1e-3


@pytest.fixture(scope="module")
def enhancer(tmp_path_factory):
    config = Config(**SERVE)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(config)
    path = tmp_path_factory.mktemp("w") / "tiny.npz"
    save_npz_state_dict(path, model.state_dict(), dtype="float32")
    return Enhancer(config, path, max_batch=2, device="cpu")


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _get_json(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("codecs", ["installed", "stdlib"])
def test_http_server(enhancer, monkeypatch, codecs):
    """/healthz, /stats, a PNG round trip at the input's size (not the
    model's 16²), ?size=WxH, and 4xx for bad requests. With "stdlib" the
    host has no cv2, PIL or native decoder, as the card's machine has
    none: the standard library's PNG decoder and writer serve."""
    if codecs == "stdlib":
        monkeypatch.setitem(sys.modules, "cv2", None)
        monkeypatch.setitem(sys.modules, "PIL", None)
        monkeypatch.setattr("hybrid_diffusion_tpu_torch.data.native."
                            "decode_image", lambda data: None)
    server = serve_http.serve(enhancer, port=0, block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        img = np.random.default_rng(0).integers(0, 256, (20, 28, 3),
                                                dtype=np.uint8)
        status, ctype, body = _post(f"{base}/enhance", _png_bytes(img))
        assert status == 200 and ctype == "image/png"
        out = _png_decode(body)
        assert out.shape == (20, 28, 3)
        # The same bytes as the Enhancer gives (its generator moved on, so
        # reseed it for both).
        enhancer._generator.manual_seed(1)
        direct = enhancer.enhance([img])[0]
        enhancer._generator.manual_seed(1)
        _, _, body = _post(f"{base}/enhance", serve_http._encode_png(img))
        np.testing.assert_array_equal(_png_decode(body), direct)
        _, _, body = _post(f"{base}/enhance?size=30x12", _png_bytes(img))
        assert _png_decode(body).shape == (12, 30, 3)
        for url, data in ((f"{base}/enhance?size=bogus", _png_bytes(img)),
                          (f"{base}/enhance", b"junk"),
                          (f"{base}/nowhere", b"")):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(url, data)
            assert err.value.code == (404 if "nowhere" in url else 400)
        assert _get_json(f"{base}/healthz") == {"status": "ok",
                                                "requests": 3}
        stats = _get_json(f"{base}/stats")
        assert stats["requests"] == 3 and stats["errors"] == 2
        assert stats["model_size"] == 16 and stats["max_batch"] == 2
        assert stats["mean_ms"] > 0
    finally:
        server.shutdown()
        server.server_close()


def test_export_round_trip(enhancer, tmp_path):
    """The artifact holds the whole program (weights, the 3-step sampler,
    uint8 in and out) with the attention op at each of its 12 calls; loaded
    here and in a fresh process that imports only the package, it gives the
    Enhancer's bytes on the same noise."""
    path = tmp_path / "enhancer.pt2"
    data = export_enhancer(enhancer, path)
    assert path.read_bytes() == data
    program = torch.export.load(str(path))
    # The sampler runs under no_grad: its ops sit in the submodule of a
    # wrap_with_set_grad_enabled node.
    ops = [n for gm in program.graph_module.modules()
           if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes
           if n.target is torch.ops.hdt.attention_fwd.default]
    assert len(ops) == 3 * 4     # 3 sampler steps, 4 attention blocks each
    run = load_exported(data)
    assert run.meta["shape"] == [2, 16, 16, 3]
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 16, 16, 3), dtype=np.uint8))
    got = run(x, torch.Generator().manual_seed(5))
    noise = torch.randn((2, 16, 16, 3),
                        generator=torch.Generator().manual_seed(5))
    want = enhancer._sample(x, None, noise)
    assert got.dtype == torch.uint8 and torch.equal(got, want)

    np.save(tmp_path / "x.npy", x.numpy())
    np.save(tmp_path / "noise.npy", noise.numpy())
    script = (
        "import sys, numpy as np, torch\n"
        "import hybrid_diffusion_tpu_torch\n"
        "d = sys.argv[1]\n"
        "m = torch.export.load(d + '/enhancer.pt2').module()\n"
        "out = m(torch.from_numpy(np.load(d + '/x.npy')),\n"
        "        torch.from_numpy(np.load(d + '/noise.npy')))\n"
        "np.save(d + '/out.npy', out.numpy())\n")
    subprocess.run([sys.executable, "-c", script, str(tmp_path)], check=True,
                   cwd=ROOT, timeout=120)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want.numpy())


def test_export_refuses_ddpm(enhancer, tmp_path):
    import dataclasses

    enhancer.config = dataclasses.replace(enhancer.config, sampler="",
                                          ddim=False)
    try:
        with pytest.raises(ValueError, match="deterministic samplers"):
            export_enhancer(enhancer)
    finally:
        enhancer.config = Config(**SERVE)


def test_plot_batch_grid(tmp_path, monkeypatch):
    loader = BatchLoader(SyntheticPairedDataset(length=4, image_size=16), 4,
                         shuffle=False, num_workers=1)
    out = plot_batch_grid(loader, num_images=3, out_path=str(tmp_path / "p.png"),
                          cols=2)
    assert out == str(tmp_path / "p.png") and Path(out).stat().st_size > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert plot_batch_grid(loader, out_path=str(tmp_path / "q.png")) is None
    assert not (tmp_path / "q.png").exists()
