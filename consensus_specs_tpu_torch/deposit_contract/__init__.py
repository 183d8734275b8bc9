from .model import DepositContractModel  # noqa: F401
