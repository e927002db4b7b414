from .tabular import load_table, save_arrow, save_csv, save_parquet, to_table

__all__ = ["save_csv", "save_arrow", "save_parquet", "to_table", "load_table"]
