"""Workspace containers and the RL drivers."""
