"""DQN with HL-Gauss histogram regression, the JAX package's
``dqn_hl_gauss.tpu``: C51's head of ``nr_atoms`` bins per action over
[v_min, v_max], valued by the histogram expectation over the bin centres;
the scalar TD target (target network, best expected next value) is smeared
into bin probabilities by a Gaussian, trained with cross-entropy."""

from rlx_tpu_torch.algorithms.c51.cuda.c51 import C51
from rlx_tpu_torch.algorithms.dqn_hl_gauss.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.ops.distributional import hl_gauss_expectation, hl_gauss_targets


class DQNHLGauss(C51):
    def expectation(self, logits):
        return hl_gauss_expectation(logits, self.v_min, self.v_max)

    def target(self, batch):
        next_expected = self.expectation(self.critic.target(batch["next_observation"]))
        y = batch["reward"] + self.gamma * (1.0 - batch["terminated"]) * next_expected.max(dim=-1).values
        return hl_gauss_targets(y, self.v_min, self.v_max, self.nr_atoms)

    def general_properties():
        return GeneralProperties
