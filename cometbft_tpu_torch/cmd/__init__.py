"""The port's command line (`python -m cometbft_tpu_torch.cmd.main`)."""
