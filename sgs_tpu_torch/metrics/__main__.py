from sgs_tpu_torch.metrics import main

if __name__ == "__main__":
    main()
