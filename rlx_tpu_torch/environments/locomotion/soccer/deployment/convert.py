"""Convert a trained rlx_tpu_torch ppo_gru ``.model`` checkpoint into
PyTorch weights + meta JSON for the RCSSServerMJ nn_client (the JAX
package's ``soccer/deployment/convert.py``).

Deployment glue mirroring the reference's
`robocup_soccer/rcssserver_deployment/convert.py:1-288` for the port's
checkpoint format and policy architecture: the ``state_dict`` of
``models/recurrent.py::RecurrentPolicy`` (cell_type="gru") is mapped onto
``torch_policy.TorchPolicyGRU``, and the meta JSON records everything the
server-side client needs to reproduce the env's action pipeline (policy
observation indices, PD scaling factor, nominal joint positions).  The
observation indices are a buffer outside the policy's ``state_dict``, so
they come from the env.

    python -m rlx_tpu_torch.environments.locomotion.soccer.deployment.convert \\
        --model latest.model --env locomotion.soccer.cuda \\
        --output locomotion_nn.pth --meta-output locomotion_nn_meta.json
"""

import argparse
import json

import numpy as np
import torch

from rlx_tpu_torch.environments.locomotion.soccer.deployment.torch_policy import TorchPolicyGRU


def deployment_state_dict(policy_state_dict):
    """``RecurrentPolicy`` (gru) state_dict -> (``TorchPolicyGRU``
    state_dict, arch dict).

    The port's ``GRUCell`` keeps the rows r, z, n of ``weight_ih`` /
    ``weight_hh`` and ``bias_ih`` as ``nn.GRUCell`` does, and one bias on
    the hidden side, ``bias_hn``: ``nn.GRUCell``'s ``bias_hh`` is ``[0, 0,
    bias_hn]``.  ``policy_logstd`` is dropped."""
    sd = dict(policy_state_dict)
    if "cell.bias_hn" not in sd:
        raise ValueError("not a RecurrentPolicy with cell_type='gru': the state has no cell.bias_hn")
    bias_hn = sd.pop("cell.bias_hn")
    hidden_dim = int(sd["cell.weight_hh"].shape[1])
    sd["cell.bias_hh"] = torch.cat([bias_hn.new_zeros(2 * hidden_dim), bias_hn])
    sd.pop("policy_logstd")
    arch = {
        "obs_dim": int(sd["cell_obs_encoder.weight"].shape[1]),
        "action_dim": int(sd["mean_head.weight"].shape[0]),
        "obs_encoding_dim": int(sd["cell_obs_encoder.weight"].shape[0]),
        "hidden_dim": hidden_dim,
        "combine_method": "film" if "film_gamma.weight" in sd else "concat",
        "share_encoder": "obs_encoder.weight" not in sd,
    }
    return sd, arch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True, help=".model checkpoint (ppo_gru)")
    parser.add_argument("--env", default="locomotion.soccer.cuda")
    parser.add_argument("--output", default="locomotion_nn.pth")
    parser.add_argument("--meta-output", default="locomotion_nn_meta.json")
    parser.add_argument("--device", default="cuda", help="the env's device, for its meta (cuda, or cpu)")
    args = parser.parse_args(argv)

    from rlx_tpu_torch.config import create_env, make_config
    from rlx_tpu_torch.utils import checkpoint as ckpt

    tree, algo_config = ckpt.load_model_file(args.model)
    sd, arch = deployment_state_dict(ckpt.policy_params(tree))

    config = make_config("ppo_gru.cuda", args.env, **{"environment.nr_envs": 1, "runner.device": args.device})
    env, _ = create_env(config)

    policy = TorchPolicyGRU(**arch)
    policy.load_state_dict(sd)
    torch.save(policy.state_dict(), args.output)

    meta = {
        **arch,
        "policy_observation_indices": np.asarray(env.policy_observation_indices).tolist(),
        "action_scaling_factor": float(env.robot_config["scaling_factor"]),
        "nominal_joint_positions": env.nominal_joint_positions.cpu().tolist(),
        "control_frequency_hz": env.control_frequency_hz,
        "algorithm_config": algo_config,
    }
    with open(args.meta_output, "w") as f:
        json.dump(meta, f, indent=1)
    print(f"wrote {args.output} and {args.meta_output}")


if __name__ == "__main__":
    main()
