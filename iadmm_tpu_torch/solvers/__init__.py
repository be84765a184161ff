"""Learned cells, the learned ADMM step, rollouts and the exact Stage II."""
