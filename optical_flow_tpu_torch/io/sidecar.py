"""CSV output, `.done` sentinels and the shot-granular checkpoint: a copy
of `optical_flow_tpu.io.sidecar` (`ShotProgress`, `write_mag_to_csv`,
`DoneSentinel`), byte-compatible with the reference and the JAX package:
  * CSV: one line, `<start_ms>\\t<end_ms>\\t<m1 m2 m3 ...>`
    (`optical_flow.py:128-132`);
  * .done: newline-joined `VERSION, frame_width, step_size, window_size,
    top_percentile` (`optical_flow.py:152`), written after success
    (`:163-165`), checked before work with string equality and a
    `force_run == 'True'` string override (`:154`);
  * <videoid>.progress: one JSON line per completed window after a
    version header (`--resume`), deleted once the CSV and `.done` land.
"""

from __future__ import annotations

import json
import os


class ShotProgress:
    """Shot-granular intra-video checkpoint.

    The reference's `.done` file is all-or-nothing — a crash redoes the
    whole video (`optical_flow.py:149-168`).  This sidecar records each
    completed window's magnitude sum as one JSON line, appended+flushed as
    device chunks complete, so a killed run resumes from the high-water
    mark instead of frame 0.  A header line carries the same version
    stamp as `.done`; a stamp mismatch (changed params) discards the
    file.  Deleted after the CSV + `.done` land — it never outlives a
    successful run, keeping the on-disk contract identical to the
    reference for completed videos.
    """

    def __init__(self, path: str, done_version: str):
        self.path = path
        self.version = done_version
        self._f = None

    def load(self) -> dict:
        """{window_index: (start, end, magsum)} of completed windows, or
        {} when absent/stale/corrupt (a torn tail line is dropped)."""
        done = {}
        if not os.path.isfile(self.path):
            return done
        try:
            with open(self.path) as f:
                header = json.loads(f.readline())
                if header.get("version") != self.version:
                    return {}
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        break             # torn write at the kill point
                    done[int(rec["i"])] = (int(rec["s"]), int(rec["e"]),
                                           float(rec["m"]))
        except (OSError, json.JSONDecodeError, KeyError, ValueError):
            return {}
        return done

    def _header_matches(self) -> bool:
        try:
            with open(self.path) as f:
                return json.loads(f.readline()).get("version") == self.version
        except (OSError, json.JSONDecodeError):
            return False

    def _open(self):
        if self._f is None:
            mode = "a" if self._header_matches() else "w"
            self._f = open(self.path, mode)
            if mode == "w":
                self._f.write(json.dumps({"version": self.version}) + "\n")
                self._f.flush()
        return self._f

    def record(self, index: int, start: int, end: int, magsum: float):
        f = self._open()
        f.write(json.dumps({"i": index, "s": start, "e": end, "m": magsum})
                + "\n")
        f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def discard(self) -> None:
        self.close()
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass


def mag_csv_line(mag, segment_timestamps) -> str:
    """The CSV's one line: `<start_ms>\\t<end_ms>\\t<m1 m2 ...>`."""
    mags = " ".join(str(m) for m in mag)
    return (str(segment_timestamps[0]) + "\t" + str(segment_timestamps[1])
            + "\t" + mags)


def write_mag_to_csv(f_path: str, mag, segment_timestamps) -> None:
    with open(f_path, "w", newline="") as f:
        f.write(mag_csv_line(mag, segment_timestamps))


class DoneSentinel:
    """Per-video idempotency marker — the reference's checkpoint/resume
    mechanism (SURVEY.md section 5, Checkpoint/resume)."""

    def __init__(self, features_dir: str, done_version: str):
        self.path = os.path.join(features_dir, ".done")
        self.version = done_version

    def is_done(self) -> bool:
        if not os.path.isfile(self.path):
            return False
        with open(self.path, "r") as f:
            return f.read() == self.version

    def mark_done(self) -> None:
        with open(self.path, "w") as f:
            f.write(self.version)
