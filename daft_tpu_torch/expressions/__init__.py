from .expressions import (  # noqa: F401
    AggExpr,
    Alias,
    BinaryOp,
    Cast,
    ColumnRef,
    Expression,
    IfElse,
    IsIn,
    Literal,
    UnaryOp,
    col,
    lit,
)
