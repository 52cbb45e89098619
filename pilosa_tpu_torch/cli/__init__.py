"""Operator CLI (cmd/root.go + ctl/ command set, cli/ fbsql shell):
``python -m pilosa_tpu_torch.cli.main <command>``."""
