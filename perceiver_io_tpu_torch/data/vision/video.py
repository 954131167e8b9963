"""Video frame I/O on the host. Counterpart of
``perceiver_io_tpu/data/vision/video.py`` (the same code): ``cv2`` when it
imports, else ``ffmpeg`` subprocesses over rawvideo pipes. The optical-flow
pipeline reads frame pairs from a video file with it and writes rendered
flow back out.
"""
from __future__ import annotations

import json
import shutil
import subprocess
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple

import numpy as np


def _have(binary: str) -> bool:
    return shutil.which(binary) is not None


def _probe(path: Path) -> Tuple[int, int, float]:
    out = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0",
         "-show_entries", "stream=width,height,r_frame_rate", "-of", "json", str(path)],
        capture_output=True, check=True,
    )
    stream = json.loads(out.stdout)["streams"][0]
    num, den = stream["r_frame_rate"].split("/")
    return int(stream["width"]), int(stream["height"]), float(num) / float(den)


def read_video_frames(path, max_frames: int = None) -> List[np.ndarray]:
    """Decode a video into a list of RGB (h, w, 3) uint8 frames."""
    path = Path(path)
    try:
        import cv2

        cap = cv2.VideoCapture(str(path))
        frames = []
        while max_frames is None or len(frames) < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        return frames
    except ImportError:
        pass
    if not _have("ffmpeg"):
        raise RuntimeError("video IO needs cv2 or ffmpeg; neither is available")
    w, h, _ = _probe(path)
    cmd = ["ffmpeg", "-v", "error", "-i", str(path),
           "-f", "rawvideo", "-pix_fmt", "rgb24"]
    if max_frames is not None:
        cmd += ["-frames:v", str(max_frames)]
    raw = subprocess.run(cmd + ["-"], capture_output=True, check=True).stdout
    n = len(raw) // (w * h * 3)
    return list(np.frombuffer(raw, np.uint8)[: n * w * h * 3].reshape(n, h, w, 3))


def write_video(path, frames: Sequence[np.ndarray], fps: int = 30) -> None:
    """Encode RGB uint8 frames to a video file."""
    path = Path(path)
    frames = [np.asarray(f, np.uint8) for f in frames]
    if not frames:
        raise ValueError("no frames to write")
    h, w = frames[0].shape[:2]
    try:
        import cv2

        writer = cv2.VideoWriter(
            str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
        )
        for frame in frames:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        writer.release()
        return
    except ImportError:
        pass
    if not _have("ffmpeg"):
        raise RuntimeError("video IO needs cv2 or ffmpeg; neither is available")
    proc = subprocess.Popen(
        ["ffmpeg", "-v", "error", "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
         "-s", f"{w}x{h}", "-r", str(fps), "-i", "-", "-pix_fmt", "yuv420p", str(path)],
        stdin=subprocess.PIPE,
    )
    for frame in frames:
        proc.stdin.write(frame.tobytes())
    proc.stdin.close()
    if proc.wait() != 0:
        raise RuntimeError("ffmpeg encode failed")


def frame_pairs(frames: Sequence[np.ndarray]) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Consecutive frame pairs for optical-flow processing."""
    for a, b in zip(frames[:-1], frames[1:]):
        yield (a, b)
