from .oracle_env import OracleEnv, OracleOps, new_state

__all__ = ["OracleEnv", "OracleOps", "new_state"]
