"""What a machine offers the slide feed: Python packages, JPEG and zlib
libraries and headers, compilers. Prints one line per fact, then one JSON
object with all of them.

    python3 -m path_gene_multimodal_tpu_torch.utils.card_probe

Each package is looked up on its own (``importlib.util.find_spec``); each
library is tried by compiling and linking a few lines of C++ against it;
JPEG through cv2 is tried in a child process (an encode and a decode), so
that this package never imports cv2 itself.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

MODULES = ("h5py", "cv2", "pyarrow", "scipy", "pandas", "networkx", "PIL", "torchvision",
           "torch_geometric", "tifffile", "imagecodecs", "turbojpeg", "simplejpeg", "zarr",
           "fastparquet")
HEADERS = ("/usr/include/jpeglib.h", "/usr/include/turbojpeg.h", "/usr/include/zlib.h",
           "/usr/local/cuda/include/nvjpeg.h")
CUDA = ["-I/usr/local/cuda/include", "-L/usr/local/cuda/lib64"]
LINK = {
    "libjpeg": ("#include <cstdio>\n#include <jpeglib.h>\nint main() { jpeg_compress_struct c; "
                "jpeg_error_mgr e; c.err = jpeg_std_error(&e); jpeg_create_compress(&c); }\n",
                ["-ljpeg"]),
    "zlib": ("#include <zlib.h>\nint main() { return zlibVersion() == nullptr; }\n", ["-lz"]),
    "nvjpeg": ("#include <nvjpeg.h>\nint main() { nvjpegHandle_t h; return nvjpegCreateSimple(&h); }\n",
               CUDA + ["-lnvjpeg"]),
}
_CV2_JPEG = ("import cv2, numpy as np; ok, b = cv2.imencode('.jpg', np.full((64, 64, 3), 90, "
             "np.uint8)); print(bool(ok) and cv2.imdecode(b, 1).shape == (64, 64, 3))")


def _run(cmd: list[str], **kw) -> tuple[int, str]:
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=120, **kw)
    except (OSError, subprocess.TimeoutExpired) as e:
        return -1, repr(e)
    return p.returncode, (p.stdout + p.stderr).strip()


def probe() -> dict:
    facts: dict = {"python": sys.version.split()[0]}
    try:
        import torch

        facts["torch"] = f"{torch.__version__} (CUDA {torch.version.cuda})"
    except ImportError:
        facts["torch"] = None
    facts["modules"] = {m: importlib.util.find_spec(m) is not None for m in MODULES}
    rc, out = _run([sys.executable, "-c", _CV2_JPEG])
    facts["cv2_jpeg_encode_decode"] = rc == 0 and out.endswith("True")
    rc, out = _run(["ldconfig", "-p"])
    facts["ldconfig"] = sorted({ln.split()[0] for ln in out.splitlines()
                                if any(k in ln for k in ("libjpeg", "libturbojpeg", "libnvjpeg",
                                                         "libz.so"))})
    facts["headers"] = {h: Path(h).exists() for h in HEADERS}
    gxx = shutil.which("g++")
    facts["g++"] = _run([gxx, "--version"])[1].splitlines()[0] if gxx else None
    facts["make"] = shutil.which("make") is not None
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    facts["nvcc"] = _run([nvcc, "--version"])[1].splitlines()[-1] if Path(nvcc).exists() else None
    facts["links"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (src, flags) in LINK.items():
            cpp = Path(tmp) / f"{name}.cpp"
            cpp.write_text(src)
            facts["links"][name] = bool(gxx) and _run(
                [gxx, str(cpp), "-o", str(Path(tmp) / name), *flags])[0] == 0
    return facts


if __name__ == "__main__":
    result = probe()
    for key, value in result.items():
        print(f"{key}: {value}")
    print(json.dumps(result))
