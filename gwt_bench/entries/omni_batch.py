"""Entry kind "omni_batch": ``BatchTranscriber.transcribe`` of a
decoder-only audio LM (Uni-MoE-2.0-Omni's speech path) over a closed loop
of batches, each of fresh clips from the seed: the batch entry's window
(``entries/batch.py``), with the LM's context and its own check.

``correct``: every request is answered with ``max_tokens`` + 1 tokens
(``short_requests``: end-of-text loses, see the configuration's
``eot_head_scale``); and over a sample of the requests drawn from the seed
(the batch entry's ``sample``), the plain reference
(``reference_unimoe.py``) teacher-forced over each request's prompt and
served tokens, and routed by the program's own chosen sets
(``UniMoEContext.last_routes``), gives per served token its gap below the
reference's best log-probability and the gap between the program's
log-probability of it and the reference's, and per token and layer how
far the program's set lies from the top-p set of the reference's router
probabilities there (``route_far``).  Routing by the program's sets keeps
the comparison to rounding: a bfloat16 hidden state flips 5-17% of the
float32 router's sets near top-p's bound (seed to seed), and each flip
moves the hidden state by more than rounding does, so a comparison of two
free-running routers measures chaos, not error; the sets themselves are
held to the router by ``route_far``.  The numbers compared are those the
workload's ``check.limits`` names; PERF.md gives the readings each limit
was set from.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import reference, reference_unimoe, weights, weights_unimoe
from ..traffic import SAMPLE_RATE
from . import batch


def port_config(cfg: dict):
    """The program's ``UniMoEConfig`` for a configuration file."""
    from godot_whisper_tpu_torch.models.config import WhisperConfig
    from godot_whisper_tpu_torch.models.unimoe import UniMoEConfig

    a = cfg["audio_encoder"]
    audio = WhisperConfig(
        name=cfg["port_name"] + "-encoder", n_vocab=51866,
        n_audio_ctx=int(a["max_source_positions"]),
        n_audio_state=int(a["d_model"]),
        n_audio_head=int(a["encoder_attention_heads"]),
        n_audio_layer=int(a["encoder_layers"]), n_text_ctx=448,
        n_text_state=int(a["d_model"]),
        n_text_head=int(a["encoder_attention_heads"]), n_text_layer=1,
        n_mels=int(a["num_mel_bins"]))
    return UniMoEConfig(
        name=cfg["port_name"], n_vocab=int(cfg["vocab_size"]),
        n_state=int(cfg["hidden_size"]),
        n_layer=int(cfg["num_hidden_layers"]),
        n_head=int(cfg["num_attention_heads"]),
        n_kv_head=int(cfg["num_key_value_heads"]),
        head_dim=int(cfg["head_dim"]),
        n_shared=int(cfg["mlp_fixed_expert_num"]),
        shared_ffn=int(cfg["shared_intermediate_size"]),
        n_routed=int(cfg["mlp_dynamic_expert_num"]),
        n_null=int(cfg["mlp_dynamic_null_expert_num"]),
        routed_ffn=int(cfg["dynamic_intermediate_size"]),
        top_p=float(cfg["mlp_dynamic_top_p"]),
        top_k=int(cfg["mlp_dynamic_top_k"]), audio=audio,
        rope_theta=float(cfg["rope_theta"]),
        rms_eps=float(cfg["rms_norm_eps"]),
        audio_frames=int(cfg["audio_frames"]),
        audio_tokens=int(cfg["whisper_query_tokens_size"]),
        token_eot=int(cfg["eot_token_id"]))


class Entry(batch.Entry):
    def setup(self) -> None:
        # the program's LM path first: a program without it stops here,
        # before any weight is drawn
        import godot_whisper_tpu_torch as gt
        from godot_whisper_tpu_torch.decode.omni import UniMoEContext
        from godot_whisper_tpu_torch.parallel.batch import BatchTranscriber

        from ..traffic import Traffic
        cfg, spec = self.cfg, self.spec
        self.ucfg = port_config(cfg)
        self.params = weights_unimoe.draw(
            cfg, self.seed, self.device, float(cfg.get("eot_head_scale", 1)))
        self.filters = weights.filterbank(
            {"num_mel_bins": cfg["audio_encoder"]["num_mel_bins"]})
        self.ctx = UniMoEContext(
            self.ucfg, self.params, device=self.device,
            mel_filters=self.filters, prompt_head=cfg["prompt_head"],
            prompt_tail=cfg["prompt_tail"], record_routes=True)
        self.bt = BatchTranscriber(self.ctx)
        self.tparams = gt.TranscribeParams(**spec["params"])
        self.traffic = Traffic(spec["traffic"], self.seed, self.device)
        self.served, self.plogs, self.routes = [], [], []
        for j in range(batch.WARMUP_BATCHES):
            self.bt.transcribe(self.traffic.clips(batch._WARMUP_K + j),
                               self.tparams)
        batch._sync(self.device)

    def window(self, seconds: float):
        """Batches back to back until ``seconds`` have passed (the batch
        entry's window); ``prompt`` counts the audio tokens too."""
        tm = self.ctx.timings
        n_decode0, n_encode0 = tm.n_decode, tm.n_encode
        k0 = len(self.served)
        t0 = t = time.perf_counter()
        unit_s = []
        while True:
            self.record(self.bt.transcribe(
                self.traffic.clips(len(self.served)), self.tparams))
            unit_s.append(time.perf_counter() - t)
            t += unit_s[-1]
            if t - t0 >= seconds:
                break
        ks = range(k0, len(self.served))
        reqs = [r for j in ks for r in self.traffic.requests(j)]
        audio_s = sum(r.n for r in reqs) / SAMPLE_RATE
        want = int(self.tparams.max_tokens) + 1
        counts = [len(x) for j in ks for x in self.served[j]]
        self.attempted += len(reqs)
        self.failed += sum(1 for n in counts if n != want)
        facts = {"units": len(ks), "unit_s": unit_s, "window_s": t - t0,
                 "rows": self.traffic.batch, "windows": len(reqs),
                 "prompt": (len(self.cfg["prompt_head"])
                            + int(self.cfg["whisper_query_tokens_size"])
                            + len(self.cfg["prompt_tail"])),
                 "served_tokens": counts,
                 "decode_steps": tm.n_decode - n_decode0,
                 "encoder_waves": tm.n_encode - n_encode0,
                 "audio_s": audio_s}
        return {"audio_s_per_s": audio_s / (t - t0)}, facts

    def record(self, segs) -> None:
        """Keep a batch's answers and the program's chosen sets (a copy on
        the device, in stream order: no sync)."""
        super().record(segs)
        self.routes.append(self.ctx.last_routes.clone())

    # ------------------------------------------------------------ checking
    def reference_logprobs(self, pick, served, mode: str = "f32",
                           forced=None, record=None):
        """The reference's log-softmax rows at the served positions of the
        sampled requests (``reference_unimoe.served_logprobs``), routed by
        ``forced`` where given."""
        reqs = {k: self.traffic.requests(k) for k in {k for k, _ in pick}}
        mels = torch.stack([
            reference.mel_window(self.traffic.clip(reqs[k][b]), self.filters,
                                 self.device) for k, b in pick])
        with torch.no_grad(), reference.precision(mode):
            return reference_unimoe.served_logprobs(
                reference_unimoe.ReferenceLM(self.params, self.cfg, mode),
                mels, self.cfg["prompt_head"], self.cfg["prompt_tail"],
                served, forced=forced, record=record)

    def compared(self, mode: str = "f32") -> Dict[str, np.ndarray]:
        """Over the sample, concatenated, with the f32 reference routed by
        the served side's chosen sets: each served token's gap below the
        reference's best log-probability, the gap between the served
        side's log-probability of it and the reference's, and how far each
        chosen set lies from the top-p set of the reference's router
        probabilities there (``reference_unimoe.route_numbers``).  The
        served side is the program (its sets from ``last_routes``), or,
        with ``mode`` another precision, the reference at it routing by
        its own router (the token it puts first, its log-probabilities)."""
        pick = self.sample()
        served = [self.served[k][b] for k, b in pick]
        if mode == "f32":
            sets = [self.routes[k][:, :, b].cpu().numpy() for k, b in pick]
            low = None
        else:
            rec: list = []
            low = self.reference_logprobs(pick, served, mode, record=rec)
            sets = [r[0] if r is not None else None for r in rec]
        rec = []
        ref = self.reference_logprobs(pick, served, forced=sets, record=rec)
        gaps, lp_gaps, far = [], [], []
        for j, (k, b) in enumerate(pick):
            if not served[j]:
                continue
            if low is None:
                gap, lp = reference.token_numbers(ref[j], served[j])
                prog = np.asarray(self.plogs[k][b], np.float64)
            else:
                gap, _ = reference.token_numbers(
                    ref[j], low[j].argmax(-1).tolist())
                _, lp = reference.token_numbers(ref[j], served[j])
                _, prog = reference.token_numbers(low[j], served[j])
            gaps.append(gap)
            lp_gaps.append(np.abs(prog - lp))
            far.append(reference_unimoe.route_numbers(
                rec[j][0], rec[j][1], float(self.cfg["mlp_dynamic_top_p"]),
                int(self.cfg["mlp_dynamic_top_k"])).ravel())
        cat = (lambda a: np.concatenate(a) if a else np.zeros(0))  # noqa
        return {"gap": cat(gaps), "logprob_gap": cat(lp_gaps),
                "route_far": cat(far)}

    @staticmethod
    def numbers(c: Dict[str, np.ndarray], bound: float) -> Dict[str, float]:
        """Every number the check can compare, from ``compared``'s gaps."""
        gap, d, far = c["gap"], c["logprob_gap"], c["route_far"]
        if not gap.size:
            return {k: float("inf") for k in (
                "widest_gap", "gap_q90", "logprob_m4", "logprob_q50",
                "logprob_q90", "logprob_over_share", "route_far",
                "route_diff_share")}
        return {"widest_gap": float(gap.max()),
                "gap_q90": float(np.quantile(gap, 0.9)),
                "logprob_m4": float(np.mean(d ** 4)),
                "logprob_q50": float(np.quantile(d, 0.5)),
                "logprob_q90": float(np.quantile(d, 0.9)),
                "logprob_over_share": float(np.mean(d > bound)),
                "route_far": float(far.max()),
                "route_diff_share": float(np.mean(far > 0))}

    def check(self, mode: str = "f32"):
        """The numbers that decide ``correct``, each with its limit (those
        the workload's ``check.limits`` names); with ``mode`` another
        precision, those of the reference at it in the program's place."""
        chk = self.spec["check"]
        lim = chk["limits"]
        got = self.numbers(self.compared(mode), float(chk["logprob_bound"]))
        got["short_requests"] = float(self.failed)
        return [(k, got[k], float(v)) for k, v in lim.items()]
