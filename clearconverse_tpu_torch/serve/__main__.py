from clearconverse_tpu_torch.serve.app import main

if __name__ == "__main__":
    main()
