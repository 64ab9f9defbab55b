"""Model download helper — the editor dock's job (the Godot addon's
model_downloader.gd:26-39 fetches ``ggml-<model>.bin`` from
huggingface.co/ggerganov/whisper.cpp), a copy of the JAX package's
``cli/download.py``.

    python -m godot_whisper_tpu_torch.cli.download tiny.en -o models/

Zero-egress environments: the tool constructs the canonical URL and uses
urllib when the network is reachable; otherwise it prints the URL and
exits 2 so callers can fetch out-of-band.
"""

from __future__ import annotations

import argparse
import os
import sys

# the 11 model choices the dock exposes (whisper_dock.tscn:18-40) plus v3
MODELS = [
    "tiny", "tiny.en", "base", "base.en", "small", "small.en",
    "medium", "medium.en", "large-v1", "large-v2", "large-v3",
    "large-v3-turbo",
]

BASE_URL = ("https://huggingface.co/ggerganov/whisper.cpp/resolve/main/"
            "ggml-{model}.bin")


def model_url(model: str) -> str:
    return BASE_URL.format(model=model)


def download(model: str, out_dir: str, *, quiet: bool = False) -> str:
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; choices: {MODELS}")
    os.makedirs(out_dir, exist_ok=True)
    dest = os.path.join(out_dir, f"ggml-{model}.bin")
    if os.path.exists(dest):
        if not quiet:
            print(f"{dest} already exists")
        return dest

    url = model_url(model)
    import urllib.request
    try:
        if not quiet:
            print(f"downloading {url}")

        def hook(blocks, bs, total):
            if quiet or total <= 0:
                return
            pct = min(100, blocks * bs * 100 // total)
            sys.stderr.write(f"\r{pct:3d}%")
            sys.stderr.flush()

        urllib.request.urlretrieve(url, dest, reporthook=hook)
        if not quiet:
            sys.stderr.write("\n")
        return dest
    except Exception as e:
        if os.path.exists(dest):
            os.unlink(dest)
        raise ConnectionError(
            f"could not fetch {url} ({e}); download it out-of-band and "
            f"place it at {dest}") from e


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gwt-download-torch")
    p.add_argument("model", choices=MODELS)
    p.add_argument("-o", "--out-dir", default="models")
    args = p.parse_args(argv)
    try:
        dest = download(args.model, args.out_dir)
    except ConnectionError as e:
        print(str(e), file=sys.stderr)
        return 2
    print(dest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
