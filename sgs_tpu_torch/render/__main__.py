from sgs_tpu_torch.render.cli import main

if __name__ == "__main__":
    main()
