"""PyTorch port, the MNIST downloader (``data/download.py``, torchvision's
``download=True``) against a local HTTP server that serves ``tests/fixtures/mnist_idx``:
no test reaches the network. The fetched files must load through the port's ingest as
the JAX package loads them (bitwise), and ``--download-data`` must train on them."""

import functools
import hashlib
import http.server
import os
import threading

import numpy as np
import pytest

from csed_514_project_distributed_training_using_pytorch_tpu.data import (
    download as jax_download,
)
from csed_514_project_distributed_training_using_pytorch_tpu.data import mnist as jax_mnist
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
    download,
    load_mnist,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import single
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import config

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "mnist_idx")


class _CountingHandler(http.server.SimpleHTTPRequestHandler):
    requests: list[str] = []

    def do_GET(self):
        type(self).requests.append(self.path)
        super().do_GET()

    def log_message(self, *a):
        pass


@pytest.fixture()
def fixture_server():
    handler = functools.partial(_CountingHandler, directory=FIXTURE_DIR)
    _CountingHandler.requests = []
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}/", _CountingHandler.requests
    finally:
        srv.shutdown()
        thread.join(timeout=10)


def _fixture_md5s() -> dict[str, str]:
    out = {}
    for name in download.FILES:
        with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
            out[name] = hashlib.md5(f.read()).hexdigest()
    return out


def test_constants_match_jax():
    assert download.FILES == jax_download.FILES
    assert download.MD5S == jax_download.MD5S
    assert download.DEFAULT_MIRRORS == jax_download.DEFAULT_MIRRORS


def test_fetch_verify_and_load_as_jax_loads(tmp_path, fixture_server):
    """All four archives fetched and checked, then loaded by both packages bitwise."""
    url, _ = fixture_server
    data_dir = str(tmp_path / "files")
    paths = download.download_mnist(data_dir, mirrors=(url,), checksums=_fixture_md5s())
    assert [os.path.basename(p) for p in paths] == list(download.FILES)
    for p in paths:
        with open(p, "rb") as got, open(os.path.join(FIXTURE_DIR, os.path.basename(p)),
                                        "rb") as want:
            assert got.read() == want.read()
    ours, theirs = load_mnist(data_dir), jax_mnist.load_mnist(data_dir)
    for a, b in zip(ours, theirs):
        assert a.source == b.source == "idx"
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert (len(ours[0]), len(ours[1])) == (128, 100)


def test_skips_existing_valid_files(tmp_path, fixture_server):
    url, requests = fixture_server
    data_dir = str(tmp_path / "files")
    sums = _fixture_md5s()
    download.download_mnist(data_dir, mirrors=(url,), checksums=sums)
    assert len(requests) == len(download.FILES)
    download.download_mnist(data_dir, mirrors=(url,), checksums=sums)
    assert len(requests) == len(download.FILES)     # checked on disk, not fetched again


def test_mirror_fallthrough(tmp_path, fixture_server):
    """A dead first mirror (connection refused) and one that answers 404 are passed over
    for the next."""
    url, requests = fixture_server
    dead = "http://127.0.0.1:9/"
    missing = url + "no-such-dir/"
    paths = download.download_mnist(str(tmp_path / "files"), mirrors=(dead, missing, url),
                                    checksums=_fixture_md5s(), timeout=5.0)
    assert all(os.path.exists(p) for p in paths)
    assert sum(r.startswith("/no-such-dir/") for r in requests) == len(download.FILES)


def test_checksum_mismatch_leaves_no_file(tmp_path, fixture_server):
    url, _ = fixture_server
    bad = dict(_fixture_md5s(), **{download.FILES[0]: "0" * 32})
    with pytest.raises(RuntimeError) as exc_info:
        download.download_mnist(str(tmp_path / "files"), mirrors=(url,), checksums=bad)
    assert isinstance(exc_info.value.__cause__, ValueError)   # the MD5 mismatch
    assert not (tmp_path / "files" / download.FILES[0]).exists()
    assert not list((tmp_path / "files").glob("*.part-*"))    # no temporary left


def test_single_trainer_downloads_then_trains_on_the_files(tmp_path, fixture_server,
                                                           monkeypatch, capsys):
    """``--download-data``: the trainer fetches the archives into ``data_dir`` before it
    loads them (mirrors pointed at the local server), then trains on the real IDX split."""
    url, requests = fixture_server
    sums = _fixture_md5s()
    monkeypatch.setattr(single, "download_mnist", lambda data_dir: download.download_mnist(
        data_dir, mirrors=(url,), checksums=sums))
    data_dir = tmp_path / "files"
    state, hist = single.main(config.SingleProcessConfig(
        device="cpu", n_epochs=1, batch_size_test=100, log_interval=1, download_data=True,
        use_host_pipeline=True, data_dir=str(data_dir), results_dir=str(tmp_path / "r"),
        images_dir=str(tmp_path / "i")))
    assert sorted(os.listdir(data_dir)) == sorted(download.FILES)
    assert len(requests) == len(download.FILES)
    assert "Loaded MNIST (idx): 128 train / 100 test" in capsys.readouterr().out
    assert int(state.step) == 2 and len(hist.test_losses) == 2
