"""Episode CSV logging with the reference's 8-column schema (the
evaluation half of ``crowdnav_tpu/utils/logging.py``, which the port may
not import).

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
    def __init__(self, outdir: str, filename: str):
        os.makedirs(outdir, exist_ok=True)
        self.path = os.path.join(outdir, filename + ".csv")
        if not os.path.isfile(self.path):
            with open(self.path, "w", newline="") as fp:
                csv.writer(fp).writerow(HEADERS)

    def record(self, episode_number, success, failure, reward, steps,
               ego_safety, social_safety, timelapse):
        with open(self.path, "a", newline="") as fp:
            csv.writer(fp).writerow([episode_number, success, failure,
                                     reward, steps, ego_safety,
                                     social_safety, timelapse])

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
            round(timelapse, 3))
