"""The inverse-rendering step: `make_train_step` on a one-rank mesh, with
the silhouette and penumbra edge terms on and Adam, fitting the scene
perturbed as the traffic says (`perturb`) to a target rendered at set-up
from the configuration's scene; only the parameters whose keys hold every
part of one of the `trainable` groups move.  Set-up drives the step
through its first `followed_steps` steps, the ones the reference follows,
and hands the same step and optimizer to the window.  Checked: each of
those steps' loss, the first step's gradient as Adam holds it (its first
moment after one step over 1 − β1) and the parameters' change after them,
each by the worst leaf."""
from __future__ import annotations

import torch

from perfbench import scene_data
from perfbench.loop_base import LoopBase
from perfbench.reference import compare as ref


class Loop(LoopBase):
    def setup(self):
        import sail_tpu_torch
        from sail_tpu_torch.parallel.mesh import make_mesh
        from sail_tpu_torch.parallel.render_sharded import (make_train_step,
                                                            render_sharded)
        from sail_tpu_torch.scene.scene import leaf_paths
        t = self.t
        H = W = t["size"]
        params, static = scene_data.make_scene(self.config["scene"],
                                               sail_tpu_torch).pack()
        keys = leaf_paths(static)
        mesh = make_mesh(1, device=self.device)
        with torch.no_grad():
            self.target = render_sharded(params.to(self.device), static,
                                         mesh, H, W, t["spp"],
                                         seed=self.rseed,
                                         max_bounces=t["bounces"])
        for key, v in t["perturb"].items():
            params[keys.index(key)] = v
        self.p = params.to(self.device).clone()
        self.opt = torch.optim.Adam([self.p], lr=t["lr"])
        mask = ref.trainable(keys, t["trainable"])
        self.step = make_train_step(
            static, mesh, H, W, t["spp"], self.opt, seed=self.rseed,
            max_bounces=t["bounces"], trainable=mask,
            n_edge_samples=t["edge_samples"], n_noise=t["edge_noise"],
            n_curve_samples=t["curve_samples"])
        start = self.p.detach().clone()
        losses, grad1 = [], None
        for _ in range(t["followed_steps"]):
            losses.append(float(self.step(self.target)))
            if grad1 is None:
                beta1 = self.opt.param_groups[0]["betas"][0]
                grad1 = self.opt.state[self.p]["exp_avg"] / (1 - beta1)
        self.out = {"losses": losses, "grad1": grad1.detach().cpu(),
                    "start": start.cpu(), "end": self.p.detach().cpu().clone()}

    def unit(self, rec, spans):
        float(self.step(self.target))

    def release(self):
        del self.step, self.opt, self.p, self.target

    def outputs(self):
        return self.out

    def reference(self, dtype):
        r = ref.train_steps(self.config, self.t, self.rseed, self.device,
                            dtype, self.t["followed_steps"])
        return {k: (v.cpu() if torch.is_tensor(v) else v)
                for k, v in r.items()}

    def compare(self, program, reference):
        mask = reference["mask"] > 0
        g = reference["grad1"].abs()
        moved = mask & (g >= 1e-3 * g[mask].median())
        loss = max(abs(a - b) / abs(b) for a, b in
                   zip(program["losses"], reference["losses"]))
        return [("loss_rel", loss),
                ("grad1_leaf", ref.worst_norm_gap(
                    program["grad1"], reference["grad1"], mask)),
                ("change_leaf", ref.worst_norm_gap(
                    program["end"] - program["start"],
                    reference["end"] - reference["start"], moved))]
