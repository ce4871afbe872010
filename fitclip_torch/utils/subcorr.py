"""Frame-vs-text similarity over time (port of ``scripts/subcorr.py``):
encode a video's frames one by one with CLIP, score each frame against one
or more texts, and draw each text's per-frame softmax probability over time
to a PNG.

    python -m fitclip_torch.utils.subcorr VIDEO_FILE TEXT [TEXT ...] [--output subcorr.png]
        [--encoder ViT-B/16] [--checkpoint-path FILE] [--bpe-path FILE]
        [--stride N] [--temperature 0.015] [--device cuda|cpu]

The plot is drawn with OpenCV, as ``utils/viz.py`` draws, since the JAX
script's matplotlib may be absent where the port runs: one polyline per text
over a time axis in seconds, with a legend. ``frame_text_probabilities`` is
the numbers the plot shows.
"""

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

# BGR colours of the texts' lines, in turn (matplotlib's first cycle).
COLOURS = ((180, 119, 31), (14, 127, 255), (44, 160, 44), (40, 39, 214), (189, 103, 148),
           (75, 86, 140), (194, 119, 227), (127, 127, 127), (34, 189, 188), (207, 190, 23))
FRAME_CHUNK = 64  # frames encoded per call


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("video_path", metavar="VIDEO_FILE")
    parser.add_argument("texts", metavar="TEXT", nargs="+")
    parser.add_argument("--output", default="subcorr.png")
    parser.add_argument("--encoder", default="ViT-B/16")
    parser.add_argument("--checkpoint-path", default=None)
    parser.add_argument("--bpe-path", default=os.environ.get("FITCLIP_BPE_PATH"))
    parser.add_argument("--stride", type=int, default=1, help="sample every Nth frame")
    parser.add_argument("--temperature", type=float, default=0.015)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


@torch.no_grad()
def frame_text_probabilities(encoder, frames: np.ndarray, texts: Sequence[str],
                             temperature: float) -> np.ndarray:
    """(N, H, W, 3) uint8 frames, already transformed to the encoder's input
    size -> (N, len(texts)) softmax over the texts of each frame's scores
    (cosine / temperature), each frame encoded as a 1-frame video."""
    device = next(encoder.model.parameters()).device
    frame_emb = torch.cat([
        encoder.encode_video(torch.from_numpy(np.ascontiguousarray(
            frames[i:i + FRAME_CHUNK, None])).to(device)).float().cpu()
        for i in range(0, len(frames), FRAME_CHUNK)]).numpy()
    ids = torch.from_numpy(np.asarray(encoder.get_tokenizer()(list(texts)))).to(device)
    text_emb = encoder.encode_text(ids).float().cpu().numpy()
    scores = (frame_emb @ text_emb.T) / temperature
    probs = np.exp(scores - scores.max(1, keepdims=True))
    return probs / probs.sum(1, keepdims=True)


def draw_timeline(times: np.ndarray, probs: np.ndarray, texts: Sequence[str],
                  output_path: str, size=(1440, 480)) -> np.ndarray:
    """Each text's probability over time as a polyline on a white canvas with
    axes and a legend; written to ``output_path``. Returns the image (BGR)."""
    import cv2

    width, height = size
    left, right, top, bottom = 70, 20, 20, 50
    image = np.full((height, width, 3), 255, np.uint8)
    plot_w, plot_h = width - left - right, height - top - bottom
    t0 = float(times[0])
    span = max(float(times[-1]) - t0, 1e-9) if len(times) > 1 else 1.0

    def point(t, p):
        return (int(round(left + (t - t0) / span * plot_w)),
                int(round(top + (1.0 - p) * plot_h)))

    font = cv2.FONT_HERSHEY_SIMPLEX
    cv2.rectangle(image, (left, top), (left + plot_w, top + plot_h), (0, 0, 0), 1)
    for tick in np.linspace(0.0, 1.0, 6):
        y = point(t0, tick)[1]
        cv2.line(image, (left - 4, y), (left, y), (0, 0, 0), 1)
        cv2.putText(image, f"{tick:.1f}", (left - 45, y + 5), font, 0.45, (0, 0, 0), 1,
                    cv2.LINE_AA)
    for tick in np.linspace(t0, t0 + span, 9):
        x = point(tick, 0.0)[0]
        cv2.line(image, (x, top + plot_h), (x, top + plot_h + 4), (0, 0, 0), 1)
        cv2.putText(image, f"{tick:.1f}", (x - 15, top + plot_h + 20), font, 0.45, (0, 0, 0),
                    1, cv2.LINE_AA)
    cv2.putText(image, "time (s)", (left + plot_w // 2 - 30, height - 8), font, 0.5,
                (0, 0, 0), 1, cv2.LINE_AA)
    for column, text in enumerate(texts):
        colour = COLOURS[column % len(COLOURS)]
        points = np.asarray([point(t, p) for t, p in zip(times, probs[:, column])], np.int32)
        cv2.polylines(image, [points.reshape(-1, 1, 2)], False, colour, 2, cv2.LINE_AA)
        y = top + 18 + 18 * column
        cv2.line(image, (left + plot_w - 260, y - 5), (left + plot_w - 235, y - 5), colour, 2)
        cv2.putText(image, text[:32], (left + plot_w - 228, y), font, 0.45, (0, 0, 0), 1,
                    cv2.LINE_AA)
    if not cv2.imwrite(output_path, image):
        raise IOError(f"could not write {output_path}")
    return image


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    from fitclip_torch.data.transforms import eval_transform
    from fitclip_torch.data.video_reader import VideoReader
    from fitclip_torch.models.clip.load import load_clip_encoder

    args = parse_args(argv)
    encoder = load_clip_encoder(name=args.encoder, checkpoint_path=args.checkpoint_path,
                                bpe_path=args.bpe_path, device=args.device).encoder
    reader = VideoReader.from_path(args.video_path)
    indices = list(range(0, len(reader), args.stride))
    frames = eval_transform(reader(indices), encoder.preprocess.image_size)
    probs = frame_text_probabilities(encoder, frames, args.texts, args.temperature)
    times = np.asarray(indices) / reader.get_avg_fps()
    draw_timeline(times, probs, args.texts, args.output)
    print(f"wrote {args.output} ({len(indices)} frames, {len(args.texts)} texts)")
    return probs


if __name__ == "__main__":
    main()
