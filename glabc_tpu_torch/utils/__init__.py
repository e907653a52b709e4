from .io import ChainWriter, carry_path, load_carry, save_carry

__all__ = ["ChainWriter", "carry_path", "load_carry", "save_carry"]
