"""Export a config-named encoder's towers as ``torch.export`` artifacts, one
program per tower for every bucket (port of ``scripts/export_serving.py``).

    python -m fitclip_torch.serving.export_serving <encoder-config> <out-dir> \\
        [--buckets 1,2,4,8,16,32] [--video-buckets 1,2,4,8] [--checkpoint ckpt.pt] \\
        [--scales scales.npz] [--overrides ++encoder.dtype=int8 +encoder.bpe_path=m.txt ...] \\
        [--device cpu]

The encoder is composed from ``config/encoder/<name>.yaml`` by the port's
config engine, on the card unless ``--device cpu`` is given. An int8 encoder
needs ``--scales``, the activation scales an offline eval persisted
(``++quant.scales_path=...``): serving never calibrates. It writes
``text.pt2``/``text.json`` and ``video.pt2``/``video.json`` under the out-dir
(``serving/export.py``), the video tower at ``--video-buckets`` where given
(its batches are larger), and prints the JSON map of tower -> bucket -> path.
Serve them with ``EMBED_EXPORT_DIR=<out-dir>`` and the same EMBED_ENCODER.
"""

import argparse
import json
from typing import List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("encoder", help="config/encoder/<name>.yaml")
    parser.add_argument("out_dir")
    parser.add_argument("--buckets", default="1,2,4,8,16,32")
    parser.add_argument("--video-buckets", default=None,
                        help="the video tower's buckets (default: --buckets)")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--scales", default=None,
                        help="calibrated activation scales .npz (int8 encoders)")
    parser.add_argument("--overrides", nargs="*", default=[],
                        help="further config overrides, e.g. ++encoder.dtype=int8")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from fitclip_torch.serving.embed_service import load_encoder
    from fitclip_torch.serving.export import export_encode_fn

    encoder = load_encoder(args.encoder, args.overrides, args.device, args.checkpoint,
                           args.scales).encoder
    buckets = [int(b) for b in args.buckets.split(",")]
    video_buckets = [int(b) for b in (args.video_buckets or args.buckets).split(",")]
    spec = encoder.preprocess
    text_item = torch.from_numpy(np.asarray(encoder.get_tokenizer()(["warmup"]))[0]).long()
    frames = spec.pad_to_min_frames or spec.num_frames
    # uint8 raw pixels: the service submits decoded frames, and encode_video owns
    # the normalization (the offline eval path's).
    video_item = torch.zeros(frames, spec.image_size, spec.image_size, 3, dtype=torch.uint8)
    written = {
        "text": export_encode_fn(encoder.encode_text, text_item.to(args.device), buckets,
                                 args.out_dir, "text"),
        "video": export_encode_fn(encoder.encode_video, video_item.to(args.device),
                                  video_buckets, args.out_dir, "video")}
    print(json.dumps({tower: {str(b): p for b, p in paths.items()}
                      for tower, paths in written.items()}, indent=2))


if __name__ == "__main__":
    main()
