"""Episode CSV logging with the reference's 8-column schema (port of
``crowdnav_tpu/utils/logging.py``, which the port may not import).

`utils.record_data` (`turtlebot3_rl_sim/src/utils.py:53-64`) appends rows
``episode_number, success_episode, failure_episode, episode_reward,
episode_step, ego_safety_score, social_safety_score, timelapse`` — training
rows carry the first five columns, eval rows all eight
(`start_td3_training.py:156-161`). Batched training produces thousands of
episodes per drain, so rows here are aggregate chunk summaries by default
with the same header; column meaning is preserved.
"""
from __future__ import annotations

import csv
import os

HEADERS = ["episode_number", "success_episode", "failure_episode",
           "episode_reward", "episode_step", "ego_safety_score",
           "social_safety_score", "timelapse"]


class EpisodeLogger:
    def __init__(self, outdir: str, filename: str,
                 extra_headers: list[str] | None = None):
        """``extra_headers``: summary keys appended as columns after the
        reference's 8 (training CSVs carry the greedy cohort's success this
        way; evaluation CSVs keep the reference schema). A CSV written with
        other columns gets the new header and its short rows padded."""
        os.makedirs(outdir, exist_ok=True)
        self.extra = list(extra_headers or [])
        self.path = os.path.join(outdir, filename + ".csv")
        want = HEADERS + self.extra
        if not os.path.isfile(self.path):
            with open(self.path, "w", newline="") as fp:
                csv.writer(fp).writerow(want)
        else:
            with open(self.path, newline="") as fp:
                rows = list(csv.reader(fp))
            if rows and rows[0] != want:
                body = [r + [""] * (len(want) - len(r)) for r in rows[1:]]
                with open(self.path, "w", newline="") as fp:
                    w = csv.writer(fp)
                    w.writerow(want)
                    w.writerows(body)

    def record(self, episode_number, success, failure, reward, steps,
               ego_safety=None, social_safety=None, timelapse=None,
               extra=()):
        row = [episode_number, success, failure, reward, steps]
        if ego_safety is not None:
            row += [ego_safety, social_safety, timelapse]
        row += list(extra)
        with open(self.path, "a", newline="") as fp:
            csv.writer(fp).writerow(row)

    def record_summary(self, summary: dict, episode_base: int,
                       timelapse: float):
        """Append one aggregate row from ``Trainer.drain_stats`` output."""
        self.record(
            episode_base + summary["episodes"],
            summary["successes"],
            summary["failures"],
            round(summary["mean_reward"], 3),
            round(summary["mean_steps"], 2),
            round(summary["mean_ego_safety"], 4),
            round(summary["mean_social_safety"], 4),
            round(timelapse, 3),
            extra=[round(summary[k], 4) if isinstance(summary.get(k), float)
                   else summary.get(k, "") for k in self.extra])
