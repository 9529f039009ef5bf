"""The multi-GPU block engine on torch.distributed (engine.py), its
multi-process dry run (multihost.py) and the launcher of both (dryrun.py)."""
