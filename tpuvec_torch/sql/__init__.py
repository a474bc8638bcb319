"""SQL surface: vec_* scalar functions, vec0 DDL parsing, Database facade."""

from tpuvec_torch.sql.engine import Database, connect
from tpuvec_torch.sql.functions import register_all

__all__ = ["Database", "connect", "register_all"]
