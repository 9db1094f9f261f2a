"""Distributed pieces of the port: checkpoints, leader election, replicas."""
