"""`python -m hyperqueue_tpu_torch <subcommand>`: the port's `hq`."""

from hyperqueue_tpu_torch.client.cli import main

if __name__ == "__main__":
    main()
