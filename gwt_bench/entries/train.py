"""Entry kind "train": ``models.training.train_step`` on batches of 30 s
windows whose log-mel the program's frontend (K1) makes in the step's
feed, with teacher-forced labels from the seed.

Set-up builds one training state from the seed's weights and drives it
through the first ``CHECKED_STEPS`` steps with the window's own call and
feed, on rows that all differ; the window then carries that same state on.
``train_samples_per_s`` is the rows trained over the window's time; every
step ends in a synchronize.

``correct``: the plain reference follows the first three steps from the
same weights and rows (its own mel, f32, TF32 off) and three numbers are
compared: the worst step's loss gap (relative), and by the worst leaf the
gap between the program's and the reference's norms of the first gradient
(the program's read from its AdamW state after one step: mu = (1 - b1) g)
and of the parameters' change over the three steps, each against the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the change: AdamW moves them by round-off alone.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import reference, weights
from ..traffic import Traffic
from . import port_config

CHECKED_STEPS = 3
B1 = 0.9                   # the program's AdamW b1 (optax's default)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def leaf_gap(prog: dict, ref: dict, keys) -> float:
    """max over ``keys`` of | |prog| - |ref| | / max(|ref|, median |ref|)."""
    rn = {k: float(ref[k].double().norm()) for k in keys}
    med = float(np.median(list(rn.values())))
    return max(abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med)
               for k in keys)


class Entry:
    E2E = {"train_samples_per_s": "samples/s"}

    def __init__(self, cfg: dict, spec: dict, seed: int, device):
        self.cfg, self.spec, self.seed, self.device = cfg, spec, seed, device
        self.attempted = self.failed = 0

    def setup(self) -> None:
        from godot_whisper_tpu_torch.audio.mel import MelFrontend
        from godot_whisper_tpu_torch.models import training

        self.training = training
        cfg = self.cfg
        self.wcfg = port_config(cfg)
        self.lr = float(self.spec["train"]["lr"])
        self.p0 = weights.draw(cfg, self.seed, self.device)
        self.filters = weights.filterbank(cfg)
        self.frontend = MelFrontend(self.filters, self.device)
        self.traffic = Traffic(self.spec["traffic"], self.seed, self.device)
        state = training.init_train_state(self.p0, self.lr)
        self.losses = []
        for k in range(CHECKED_STEPS):
            state, loss = training.train_step(state, self.wcfg, self.batch(k),
                                              lr=self.lr, device=self.device)
            self.losses.append(float(loss))
            if k == 0:
                self.mu1 = state.opt_state.mu
        self.p3 = state.params
        self.state = state
        _sync(self.device)

    def batch(self, k: int) -> dict:
        """Step k's rows: the mel of its clips through the program's
        frontend, cut to the 30 s window, and its labels."""
        mel, _ = self.frontend.device_batch(self.traffic.clips(k))
        n = 2 * int(self.cfg["max_source_positions"])
        lab = self.traffic.labels(k, self.cfg["task_prefix"],
                                  int(self.cfg["eos_token_id"]))
        out = {"mel": mel[:, :, :n].transpose(1, 2).contiguous()}
        for key, v in lab.items():
            out[key] = torch.from_numpy(v).to(self.device)
        return out

    def window(self, seconds: float):
        """Steps until ``seconds`` have passed; a second call goes on with
        the run's next steps."""
        tt = self.training
        k0 = self.state.step
        t0 = t = time.perf_counter()
        unit_s = []
        while True:
            self.state, loss = tt.train_step(self.state, self.wcfg,
                                             self.batch(self.state.step),
                                             lr=self.lr, device=self.device)
            _sync(self.device)
            unit_s.append(time.perf_counter() - t)
            t += unit_s[-1]
            if t - t0 >= seconds:
                break
        t1 = t
        steps = self.state.step - k0
        rows = self.traffic.batch
        self.attempted += steps
        self.failed += 0 if np.isfinite(float(loss)) else 1
        facts = {"units": steps, "unit_s": unit_s, "window_s": t1 - t0,
                 "rows": rows,
                 "T": int(self.spec["traffic"]["T"])}
        return {"train_samples_per_s": steps * rows / (t1 - t0)}, facts

    def release(self) -> None:
        self.state = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ checking
    def reference_steps(self, mode: str = "f32"):
        """The reference's losses, first gradients and params after the
        checked steps, from the same weights and rows."""
        batches = []
        for k in range(CHECKED_STEPS):
            lab = self.traffic.labels(k, self.cfg["task_prefix"],
                                      int(self.cfg["eos_token_id"]))
            b = {key: torch.from_numpy(v).to(self.device)
                 for key, v in lab.items()}
            b["pcm"] = self.traffic.clips(k)
            b["filters"] = self.filters
            batches.append(b)
        return reference.train_steps(
            self.p0, self.cfg, batches, self.lr,
            float(self.spec["train"]["weight_decay"]), mode)

    def numbers(self, losses, g1, p3) -> dict:
        """The three compared numbers of a run against the f32 reference:
        ``losses`` / ``g1`` / ``p3`` are the run's (flat by leaf)."""
        r_losses, r_g1, r_p3 = self.ref
        p0 = reference.flatten(self.p0)
        keys = list(r_g1)
        gn = {k: float(r_g1[k].double().norm()) for k in keys}
        med = float(np.median(list(gn.values())))
        moved = [k for k in keys if gn[k] >= 1e-3 * med]
        dp = {k: p3[k].float() - p0[k].float() for k in moved}
        dr = {k: r_p3[k] - p0[k].float() for k in moved}
        return {
            "loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, r_losses)),
            "grad_norm_gap": leaf_gap(g1, r_g1, keys),
            "change_norm_gap": leaf_gap(dp, dr, moved),
        }

    def check(self, mode: str = "f32"):
        """The numbers that decide ``correct``, each with its limit; with
        ``mode`` another precision, those of the reference at it put in the
        program's place (a control)."""
        self.ref = self.reference_steps("f32")
        if mode == "f32":
            mu1 = reference.flatten(self.mu1)
            g1 = {k: v.float() / (1.0 - B1) for k, v in mu1.items()}
            got = self.numbers(self.losses, g1, reference.flatten(self.p3))
        else:
            got = self.numbers(*self.reference_steps(mode))
        lim = self.spec["check"]["limits"]
        return [(k, float(v), float(lim[k])) for k, v in got.items()]
