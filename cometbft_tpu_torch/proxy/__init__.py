"""Copy of `cometbft_tpu/proxy/__init__.py` in the port."""

from .multi_app_conn import AppConns, local_client_creator, remote_client_creator

__all__ = ["AppConns", "local_client_creator", "remote_client_creator"]
