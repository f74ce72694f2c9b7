from kmtricks_tpu_torch.cli import main_with_backtrace

if __name__ == "__main__":
    raise SystemExit(main_with_backtrace())
