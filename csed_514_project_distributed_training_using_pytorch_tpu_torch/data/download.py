"""First-party MNIST downloader: the counterpart of ``torchvision.datasets.MNIST(download=
True)`` (reference ``src/train.py:26-31``: the first run fetches the four IDX archives into
the data root before training), and the port's own copy of the JAX package's
``data/download.py``.

Stdlib only (``urllib``): the mirrors are tried in order, each archive is checked against
torchvision's pinned MD5 digests, and installed atomically (fetched to a temporary file in
the target directory, checked, then ``os.replace``d), so a failed or interrupted download
never leaves a truncated archive where ``load_mnist`` would find it, and co-hosted ranks
that fetch at once each install a whole file. Files already present that pass their
checksum are not fetched again. The tests serve ``tests/fixtures/mnist_idx`` from a local
HTTP server (``tests/test_torch_port_download.py``).
"""

from __future__ import annotations

import hashlib
import http.client
import os
import tempfile
import urllib.error
import urllib.request

# torchvision's archive set; installed directly into <data_dir>, which load_mnist searches
FILES = (
    "train-images-idx3-ubyte.gz",
    "train-labels-idx1-ubyte.gz",
    "t10k-images-idx3-ubyte.gz",
    "t10k-labels-idx1-ubyte.gz",
)

# mirrors in preference order (the classic yann.lecun.com host throttles and refuses)
DEFAULT_MIRRORS = (
    "https://ossci-datasets.s3.amazonaws.com/mnist/",
    "https://storage.googleapis.com/cvdf-datasets/mnist/",
)

# torchvision's pinned MD5 digests of the four archives
MD5S = {
    "train-images-idx3-ubyte.gz": "f68b3c2dcbeaaa9fbdd348bbdeb94873",
    "train-labels-idx1-ubyte.gz": "d53e105ee54ea40749a09fcbcd1e9432",
    "t10k-images-idx3-ubyte.gz": "9fb629c4189551a2d022fa330f9573f3",
    "t10k-labels-idx1-ubyte.gz": "ec29112dd5afa0611ce80d1b7f02629c",
}


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_mnist(data_dir: str = "files", *,
                   mirrors: tuple[str, ...] = DEFAULT_MIRRORS,
                   checksums: dict[str, str] | None = None,
                   timeout: float = 30.0) -> list[str]:
    """Ensure the four MNIST IDX archives exist, checked, under ``data_dir``; return their
    paths.

    ``checksums`` maps a file name to its expected MD5 (default torchvision's digests;
    ``{}`` checks nothing). A checksum mismatch counts as that mirror failing: the download
    is removed and the next mirror tried. When every mirror fails for a file, raises
    ``RuntimeError`` chained from the last error (the ``ValueError`` of a mismatch when
    corruption was the cause).
    """
    if checksums is None:
        checksums = MD5S
    os.makedirs(data_dir, exist_ok=True)
    paths = []
    for name in FILES:
        dest = os.path.join(data_dir, name)
        expected = checksums.get(name)
        if os.path.exists(dest) and (expected is None or _md5(dest) == expected):
            paths.append(dest)
            continue

        last_err: Exception | None = None
        for base in mirrors:
            url = base + name
            fd, tmp = tempfile.mkstemp(dir=data_dir, prefix=name + ".part-")
            try:
                with urllib.request.urlopen(url, timeout=timeout) as resp, \
                        os.fdopen(fd, "wb") as out:
                    fd = None
                    while chunk := resp.read(1 << 20):
                        out.write(chunk)
                if expected is not None and (got := _md5(tmp)) != expected:
                    raise ValueError(f"{url}: MD5 mismatch — got {got}, "
                                     f"expected {expected}")
                # mkstemp creates 0600; install with the umask's permissions so that a
                # shared data_dir stays readable by other users, as torchvision's is
                umask = os.umask(0)
                os.umask(umask)
                os.chmod(tmp, 0o666 & ~umask)
                os.replace(tmp, dest)     # atomic: never a truncated file at dest
                tmp = None
                break
            except (urllib.error.URLError, http.client.HTTPException,
                    OSError, ValueError) as e:
                last_err = e
            finally:
                if fd is not None:
                    os.close(fd)
                if tmp is not None and os.path.exists(tmp):
                    os.remove(tmp)
        else:
            raise RuntimeError(
                f"could not download {name} from any of {list(mirrors)}"
            ) from last_err
        paths.append(dest)
    return paths
