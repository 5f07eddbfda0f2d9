"""Atari (ALE) host environments (reference: rl_x/environments/gym/atari/)."""
