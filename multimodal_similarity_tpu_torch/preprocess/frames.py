"""Video frame extraction at 3 fps via ffmpeg.

Reference: preprocess/get_frames.py:12-41.  Requires the ffmpeg binary;
gated at call time.

The port's copy of the JAX package's ``preprocess/frames.py`` (the port
imports nothing of that package).
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
import sys
from typing import Sequence


def extract_frames(video_path: str, out_dir: str, fps: int = 3) -> int:
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg binary not found on PATH")
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    subprocess.run(
        ["ffmpeg", "-loglevel", "error", "-i", video_path,
         "-vf", f"fps={fps}", os.path.join(out_dir, "frame_%04d.jpg")],
        check=True)
    return len(glob.glob(os.path.join(out_dir, "frame_*.jpg")))


def extract_sessions(session_ids: Sequence[str], video_template: str,
                     frame_dir: str, fps: int = 3) -> None:
    """video_template: glob with {session}, e.g.
    '/data/{session}/camera/center/*.mp4'."""
    for session_id in session_ids:
        matches = glob.glob(video_template.format(session=session_id))
        if not matches:
            print(f"no video for {session_id}, skipping")
            continue
        n = extract_frames(matches[0],
                           os.path.join(frame_dir, session_id), fps)
        print(f"{session_id}: {n} frames")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--video_template", required=True)
    p.add_argument("--frame_dir", required=True)
    p.add_argument("--session_file", required=True)
    p.add_argument("--fps", type=int, default=3)
    args = p.parse_args(argv)
    with open(args.session_file) as f:
        sessions = f.read().strip().split("\n")
    extract_sessions(sessions, args.video_template, args.frame_dir, args.fps)


if __name__ == "__main__":
    main(sys.argv[1:])
