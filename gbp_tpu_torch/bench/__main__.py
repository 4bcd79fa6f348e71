"""`python -m gbp_tpu_torch.bench`: the port's headline benchmark
(`bench/headline.py`)."""
from gbp_tpu_torch.bench.headline import main

if __name__ == "__main__":
    main()
